from .packing import pack_video_np
from .tfrecord import (
    TFRecordWriter,
    list_shards,
    make_uint8_example,
    parse_example_uint8,
    read_records,
    tfrecord_batches,
)
from .video_dataset import (
    DEFAULT_MEAN,
    DEFAULT_STD,
    PrefetchIterator,
    VideoDataset,
    VideoRecord,
    records_from_folders,
    records_from_split_file,
    sample_clip_indices,
)
