from .config import AttrDict, default_config, load_config
from .labels import kinetics400_labels, load_label_map
