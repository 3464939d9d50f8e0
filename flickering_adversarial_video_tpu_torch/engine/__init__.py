from .attack_step import AttackConfig, AttackEngine, AttackState, RuntimeFlags
