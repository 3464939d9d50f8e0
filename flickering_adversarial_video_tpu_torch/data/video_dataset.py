"""Video dataset of the mean/std (torch) attack world, and the thread
prefetcher of the host input pipeline.

Port of the JAX package's ``data/video_dataset.py``: ``VideoRecord``,
``records_from_split_file`` ('<path> <label>' lines), ``records_from_folders``
(<root>/<class>/<video>), ``sample_clip_indices`` (uniform or random
temporal offset, optional jitter, pad-by-repeat), ``VideoDataset`` (decode,
resize the short side to 128 keeping the ratio, a center or random crop of
112, an optional horizontal flip; uint8 [T,S,S,3] clips, normalized on the
device by the engine) and ``PrefetchIterator``.

Decoding uses OpenCV (``cv2``), imported at the decode as in the JAX
package; on a machine without it a decode raises ``RuntimeError`` (the
port's card has none: stub ``VideoDataset._decode`` there).  A frame whose
short side is already the target keeps its size, and the resize is skipped
(OpenCV's resize to the same size is a copy), so such frames need no cv2.

Unlike the JAX class, an exception in the prefetcher's producer does not
end the stream silently: it is raised again in the consumer, at the point
where the next item would have come.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

DEFAULT_MEAN = (0.43216, 0.394666, 0.37645)
DEFAULT_STD = (0.22803, 0.22145, 0.216989)


@dataclass
class VideoRecord:
    path: str
    label: int


def records_from_split_file(split_file: str, video_root: str = "") -> List[VideoRecord]:
    """Lines '<relative_path> <label>'."""
    records = []
    with open(split_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            path, label = line.rsplit(" ", 1)
            records.append(VideoRecord(os.path.join(video_root, path), int(label)))
    return records


def records_from_folders(root: str, class_names: Sequence[str]) -> List[VideoRecord]:
    """Per-class folder layout <root>/<class>/<video>.mp4."""
    records = []
    for label, cls in enumerate(class_names):
        d = os.path.join(root, cls)
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            records.append(VideoRecord(os.path.join(d, name), label))
    return records


def sample_clip_indices(
    num_frames: int,
    sample_length: int,
    *,
    random_offset: bool = False,
    temporal_jitter: bool = False,
    jitter_step: int = 2,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Frame indices for one clip: uniform or random start offset, optional
    per-frame jitter, pad-by-repeat when the video is shorter than the clip."""
    rng = rng or np.random.default_rng()
    if num_frames >= sample_length:
        if random_offset:
            start = int(rng.integers(0, num_frames - sample_length + 1))
        else:
            start = (num_frames - sample_length) // 2
        idx = np.arange(start, start + sample_length)
        if temporal_jitter:
            jitter = rng.integers(-jitter_step, jitter_step + 1, sample_length)
            idx = np.clip(idx + jitter, 0, num_frames - 1)
    else:
        idx = np.arange(sample_length) % num_frames  # pad by repeat
    return idx.astype(np.int64)


def _import_cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "decoding or resizing a video needs OpenCV (cv2), which this machine lacks; "
            "give VideoDataset decoded frames instead (replace its _decode)") from e
    return cv2


def _resize_keep_ratio(frame: np.ndarray, short_side: int) -> np.ndarray:
    h, w = frame.shape[:2]
    scale = short_side / min(h, w)
    size = (int(round(w * scale)), int(round(h * scale)))
    if size == (w, h):
        return frame
    return _import_cv2().resize(frame, size)


class VideoDataset:
    """Clip sampler over a record list.

    train mode: random temporal offset + random crop + random hflip;
    eval mode: uniform offset + center crop."""

    def __init__(
        self,
        records: Sequence[VideoRecord],
        *,
        sample_length: int = 16,
        input_size: int = 112,
        im_scale: int = 128,
        random_offset: bool = True,
        random_crop: bool = True,
        random_flip: bool = True,
        temporal_jitter: bool = False,
        seed: int = 0,
    ):
        self.records = list(records)
        self.sample_length = sample_length
        self.input_size = input_size
        self.im_scale = im_scale
        self.random_offset = random_offset
        self.random_crop = random_crop
        self.random_flip = random_flip
        self.temporal_jitter = temporal_jitter
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.records)

    def _decode(self, path: str) -> Optional[np.ndarray]:
        """uint8 RGB frames [N, H, W, 3] of the video at `path`, or None."""
        cv2 = _import_cv2()
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            return None
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        if not frames:
            return None
        return np.asarray(frames)

    def load_clip(self, record: VideoRecord) -> Optional[np.ndarray]:
        """uint8 [sample_length, input_size, input_size, 3]."""
        video = self._decode(record.path)
        if video is None:
            return None
        idx = sample_clip_indices(
            len(video),
            self.sample_length,
            random_offset=self.random_offset,
            temporal_jitter=self.temporal_jitter,
            rng=self.rng,
        )
        clip = video[idx]
        flip = self.random_flip and bool(self.rng.integers(2))
        out = np.empty((self.sample_length, self.input_size, self.input_size, 3), np.uint8)
        # crop offsets chosen once per clip (video-level spatial transform)
        first = _resize_keep_ratio(clip[0], self.im_scale)
        h, w = first.shape[:2]
        if self.random_crop:
            y = int(self.rng.integers(0, max(h - self.input_size, 0) + 1))
            x = int(self.rng.integers(0, max(w - self.input_size, 0) + 1))
        else:
            y = (h - self.input_size) // 2
            x = (w - self.input_size) // 2
        for t, frame in enumerate(clip):
            f = _resize_keep_ratio(frame, self.im_scale)
            f = f[y: y + self.input_size, x: x + self.input_size]
            if flip:
                f = f[:, ::-1]
            out[t] = f
        return out

    def batches(
        self, batch_size: int, *, drop_remainder: bool = True, shuffle: bool = True
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield {'video': uint8 [B,T,S,S,3], 'labels': int64 [B], 'paths': list};
        an unreadable video is skipped."""
        order = np.arange(len(self.records))
        if shuffle:
            self.rng.shuffle(order)
        videos, labels, paths = [], [], []
        for i in order:
            rec = self.records[int(i)]
            clip = self.load_clip(rec)
            if clip is None:
                continue
            videos.append(clip)
            labels.append(rec.label)
            paths.append(rec.path)
            if len(videos) == batch_size:
                yield {"video": np.stack(videos), "labels": np.asarray(labels, np.int64),
                       "paths": paths}
                videos, labels, paths = [], [], []
        if videos and not drop_remainder:
            yield {"video": np.stack(videos), "labels": np.asarray(labels, np.int64),
                   "paths": paths}


class PrefetchIterator:
    """Iterate `it` on a daemon thread, `depth` items ahead.  `close()`
    stops the producer when the consumer leaves early."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._error = None

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def fill():
            try:
                for item in it:
                    if not put(item):
                        return
            except BaseException as e:  # handed to the consumer, which re-raises
                self._error = e
            put(self._done)

        self._t = threading.Thread(target=fill, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            self._q.put(self._done)  # a second next() ends (or raises) again
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer and wait for it."""
        self._stop.set()
        self._t.join()
