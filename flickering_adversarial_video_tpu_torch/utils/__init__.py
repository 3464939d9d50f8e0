from .config import AttrDict, default_config, load_config
from .labels import kinetics400_labels, load_label_map
from .system import db_num_workers, num_devices, system_info
