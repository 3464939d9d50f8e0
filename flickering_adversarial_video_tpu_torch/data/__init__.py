from .packing import pack_video_np
