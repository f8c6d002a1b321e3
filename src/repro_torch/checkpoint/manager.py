"""Checkpoint manager: retention, async writes, auto-resume — the
counterpart of ``repro.checkpoint.manager``.

The async writer is another instance of the decoupled pattern: the train
loop issues a snapshot request and keeps stepping; the writer thread is
the Execute side draining a bounded queue.  JAX's arrays are immutable,
so its snapshot may be written later; the port's parameters and moments
are updated in place, so ``save`` copies the state to host memory before
it returns and the writer only ever sees that copy.
"""

from __future__ import annotations

import queue
import re
import threading
import time
from pathlib import Path
from typing import Any, List, NamedTuple, Optional, Tuple

from repro_torch.checkpoint.io import flatten, load_pytree, write_flat

_STEP_RE = re.compile(r"step_(\d+)\.npz$")


class Write(NamedTuple):
    """One published checkpoint: its step, the seconds its file took to
    write (the host snapshot not included) and its size in bytes."""
    step: int
    seconds: float
    nbytes: int


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 async_write: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self.writes: List[Write] = []
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._error: Optional[BaseException] = None
        self._thread = None
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # -- write ---------------------------------------------------------------
    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}.npz"

    def _check(self) -> None:
        if self._error:
            raise RuntimeError("checkpoint writer failed") from self._error

    def save(self, step: int, state: Any, meta: Optional[dict] = None,
             block: bool = False) -> None:
        """Snapshot ``state`` to host memory now, then write it (on the
        writer thread unless ``block`` or the manager is synchronous; a
        blocking save first lets the queued writes finish)."""
        self._check()
        meta = dict(meta or {}, step=step)
        flat, dtypes = flatten(state)
        if self.async_write and not block:
            self._q.put((step, flat, dtypes, meta))
        else:
            self.wait()
            self._write(step, flat, dtypes, meta)

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                self._write(*item)
            except Exception as e:  # surfaced on next save()/wait()
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, step: int, flat, dtypes, meta: dict) -> None:
        path = self._path(step)
        t0 = time.perf_counter()
        write_flat(path, flat, dtypes, meta)
        self.writes.append(Write(step, time.perf_counter() - t0,
                                 path.stat().st_size))
        self._gc()

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_*.npz"))
        for old in ckpts[:-self.keep]:
            old.unlink(missing_ok=True)

    def wait(self) -> None:
        """Block until every queued write is published."""
        if self._thread is not None:
            self._q.join()
        self._check()

    def close(self) -> None:
        """Finish the queued writes and stop the writer thread."""
        if self._thread is not None:
            self._q.join()
            self._q.put(None)
            self._thread.join()
            self._thread = None
        self._check()

    # -- read ----------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for p in self.dir.glob("step_*.npz"):
            m = _STEP_RE.search(p.name)
            if m:
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore_latest(self, like: Any) -> Optional[Tuple[int, Any, dict]]:
        """(step, ``like`` restored from the newest checkpoint, metadata),
        or None without one."""
        step = self.latest_step()
        if step is None:
            return None
        state, meta = load_pytree(self._path(step), like)
        return step, state, meta
