from .i3d import I3D_ENDPOINTS, InceptionI3D
from .video_resnet import VARIANTS, VideoResNet, mc3_18, r2plus1d_18, r2plus1d_34, r3d_18
