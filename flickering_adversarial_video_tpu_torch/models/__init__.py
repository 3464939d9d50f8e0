from .i3d import I3D_ENDPOINTS, InceptionI3D
