"""Kinetics mp4 -> tfrecord shard writers (CLI).

The port's own copy of the JAX package's ``data/write_tfrecords.py``: the
reference's conversion tools on the port's own tfrecord writer (no
TensorFlow needed), record for record the JAX package's bytes:
  * per-class mode (kinetics_to_tf_record_uint8.py): one shard series per
    class directory, NUM_VID_PER_RECORD=100 videos/shard, keep the LAST
    n_frames frames, skip (and optionally delete) short or unreadable clips
    (:75-86; deletion is opt-in here, the reference deletes unconditionally);
  * shuffled mode (kinetics_to_tf_record_uint8_shuffle.py): all classes
    interleaved with a seeded shuffle, 50 videos/shard;
  * a UCF-style split list into one float-schema shard
    (pre_process_rgb_flow.py:269-307).

uint8 clips are stored exactly like the reference: raw uint8 [T,224,224,3]
bytes under 'train/video' + int64 'train/label', i.e. the 256-resize/224-crop
preprocessing WITHOUT the float normalization (that happens on the device).
Decoding needs cv2 (``data/video.py``): a host tool, run on the CPU.

Usage:
  python -m flickering_adversarial_video_tpu_torch.data.write_tfrecords \
      --videos-dir /data/kinetics/val --out-dir /data/tfrecord_uint8/val \
      [--shuffle] [--frames 90] [--per-shard 100] [--label-map map.txt]
"""

from __future__ import annotations

import argparse
import os
import random
from typing import List, Optional, Tuple

import numpy as np

from ..utils.labels import load_label_map
from .tfrecord import TFRecordWriter, make_float_example, make_uint8_example
from .video import video_to_frames


def _load_clip_uint8(path: str, frames: int) -> Optional[np.ndarray]:
    clip = video_to_frames(path, n_steps=frames, dtype="uint8")
    if clip is None:
        return None
    clip = clip[0]
    if clip.shape[0] < frames:
        return None  # too short: skip (reference deletes, :75-86)
    return clip[-frames:]


def write_class_shards(
    class_dir: str,
    label: int,
    out_dir: str,
    *,
    frames: int = 90,
    per_shard: int = 100,
    delete_corrupt: bool = False,
) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    videos = sorted(os.listdir(class_dir))
    shards: List[str] = []
    writer = None
    count = 0
    shard_idx = 0
    for name in videos:
        path = os.path.join(class_dir, name)
        clip = _load_clip_uint8(path, frames)
        if clip is None:
            if delete_corrupt:
                try:
                    os.remove(path)
                except OSError:
                    pass
            continue
        if writer is None or count % per_shard == 0:
            if writer is not None:
                writer.close()
            shard_path = os.path.join(out_dir, f"shard_{shard_idx:04d}.tfrecords")
            writer = TFRecordWriter(shard_path)
            shards.append(shard_path)
            shard_idx += 1
        writer.write(make_uint8_example(clip, label))
        count += 1
    if writer is not None:
        writer.close()
    return shards


def write_shuffled_shards(
    videos_dir: str,
    out_dir: str,
    class_names: List[str],
    *,
    frames: int = 90,
    per_shard: int = 50,
    seed: int = 0,
) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    items: List[Tuple[str, int]] = []
    for label, cls in enumerate(class_names):
        d = os.path.join(videos_dir, cls.replace(" ", "_"))
        if not os.path.isdir(d):
            d = os.path.join(videos_dir, cls)
            if not os.path.isdir(d):
                continue
        for name in sorted(os.listdir(d)):
            items.append((os.path.join(d, name), label))
    random.Random(seed).shuffle(items)

    shards: List[str] = []
    writer = None
    count = 0
    shard_idx = 0
    for path, label in items:
        clip = _load_clip_uint8(path, frames)
        if clip is None:
            continue
        if writer is None or count % per_shard == 0:
            if writer is not None:
                writer.close()
            shard_path = os.path.join(out_dir, f"all_cls_{shard_idx:04d}.tfrecords")
            writer = TFRecordWriter(shard_path)
            shards.append(shard_path)
            shard_idx += 1
        writer.write(make_uint8_example(clip, label))
        count += 1
    if writer is not None:
        writer.close()
    return shards


def write_split_list_shard(
    split_list_path: str,
    video_root: str,
    out_path: str,
    class_names: List[str],
    *,
    frames: int = 90,
    class_filter: Optional[List[str]] = None,
) -> int:
    """UCF-style float-schema writer (pre_process_rgb_flow.py:269-307):
    read '<class>/<video>' lines from a test-list file, preprocess each clip
    (256-resize / 224-crop / x/128-1) and write FloatList records; clips
    shorter than frames-1 are skipped (:300-301).  Returns records written.
    """
    with open(split_list_path) as f:
        entries = [line.strip() for line in f if line.strip()]
    if class_filter:
        entries = [e for e in entries if any(c in e for c in class_filter)]
    written = 0
    with TFRecordWriter(out_path) as w:
        for entry in entries:
            cls, vid = entry.split("/", 1)
            label = class_names.index(cls.replace("_", " "))
            clip = video_to_frames(os.path.join(video_root, vid), n_steps=frames)
            if clip is None or clip.shape[1] < frames - 1:
                continue
            w.write(make_float_example(clip[0], label))
            written += 1
    return written


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--videos-dir", required=True, help="root of per-class video dirs")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--label-map", default=None)
    p.add_argument("--frames", type=int, default=90)
    p.add_argument("--per-shard", type=int, default=None)
    p.add_argument("--shuffle", action="store_true", help="all-class shuffled shards")
    p.add_argument("--delete-corrupt", action="store_true")
    args = p.parse_args(argv)

    class_names = load_label_map(args.label_map)
    if args.shuffle:
        shards = write_shuffled_shards(
            args.videos_dir,
            args.out_dir,
            class_names,
            frames=args.frames,
            per_shard=args.per_shard or 50,
        )
    else:
        shards = []
        for label, cls in enumerate(class_names):
            d = os.path.join(args.videos_dir, cls.replace(" ", "_"))
            if not os.path.isdir(d):
                continue
            shards += write_class_shards(
                d,
                label,
                os.path.join(args.out_dir, cls.replace(" ", "_")),
                frames=args.frames,
                per_shard=args.per_shard or 100,
                delete_corrupt=args.delete_corrupt,
            )
    print(f"wrote {len(shards)} shards")


if __name__ == "__main__":
    main()
