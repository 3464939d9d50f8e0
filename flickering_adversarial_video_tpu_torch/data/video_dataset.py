"""Thread prefetcher for the host input pipeline.

Port of ``PrefetchIterator`` of the JAX package's ``data/video_dataset.py``
(that class only).  The producer thread runs the iterator (record parse,
packing, and whatever move to the device the iterator itself does), so the
host pipeline overlaps the device's steps.

Unlike the JAX class, an exception in the producer does not end the stream
silently: it is raised again in the consumer, at the point where the next
item would have come.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator


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
