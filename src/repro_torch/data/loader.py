"""Host-side prefetching loader — the decoupled host->device feed: the
counterpart of ``repro.data.loader``.

The background thread is the Access loop (it issues batch construction
ahead of consumption); the bounded queue is the stream FIFO; the train
loop is the Execute loop.  Capacity bounds (queue size) make it
deadlock-free by construction, exactly like the paper's §5.1 rule.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional


class PrefetchLoader:
    def __init__(self, it: Iterator[Any], capacity: int = 2,
                 transform: Optional[Callable[[Any], Any]] = None):
        self._it = it
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=capacity)
        self._transform = transform
        self._done = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        finally:
            try:
                self._q.put(self._done, timeout=1.0)
            except queue.Full:
                pass

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
