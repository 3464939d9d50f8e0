from .tensorboard import ScalarWriter
