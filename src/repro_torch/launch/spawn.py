"""Run one function on every rank of a new ``torch.distributed`` group.

    results = spawn(fn, world, *args, backend="gloo")

starts ``world`` fresh Python processes (``python -m
repro_torch.launch.spawn``), one per rank.  Each joins the group through
a ``FileStore`` in a temporary directory, so no TCP port is fixed and
several launches can run side by side; calls ``fn(*args)``; and sends
back what it returns, which ``spawn`` returns in rank order.  ``fn``
must be a module-level function (a script's own functions are loaded
from its file under another name, so its ``__main__`` block does not
run again), and ``args`` and results must pickle.

Under ``gloo`` each rank runs one CPU thread (``world`` ranks share the
machine's cores); under ``nccl`` rank ``r`` takes card ``r`` modulo the
visible cards as its current device.  A rank imports only ``repro_torch``
and ``fn``'s module.  If a rank fails, the others are killed (they would
wait in a collective for it) and ``spawn`` raises with the failing
rank's output; so it does when ``timeout`` seconds pass.

Build the CUDA kernels once before spawning card ranks
(``kernels.common.build_kernels``): each rank would otherwise run every
``nvcc`` itself.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, List

__all__ = ["spawn"]

_SRC = str(Path(__file__).resolve().parents[2])


def _fn_ref(fn: Callable) -> tuple:
    """How a rank finds ``fn``: its module's name, or the file of the
    script it was defined in, and its qualified name."""
    mod = sys.modules[fn.__module__]
    if fn.__module__ == "__main__":
        return ("file", str(Path(mod.__file__).resolve()), fn.__qualname__)
    return ("module", fn.__module__, fn.__qualname__)


def _resolve(ref: tuple) -> Callable:
    kind, where, qualname = ref
    if kind == "file":
        spec = importlib.util.spec_from_file_location("_spawned_main", where)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["_spawned_main"] = mod
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    obj: Any = mod
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _tail(path: Path, n: int = 6000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def spawn(fn: Callable, world: int, *args, backend: str = "gloo",
          timeout: float = 900.0) -> List[Any]:
    """``fn(*args)`` on ranks 0..world-1 of a new group (module
    docstring); returns the ranks' results in rank order."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    job = Path(tempfile.mkdtemp(prefix="repro_spawn_"))
    procs = []
    try:
        with open(job / "job.pkl", "wb") as f:
            pickle.dump({"fn": _fn_ref(fn), "args": args, "world": world,
                         "backend": backend, "path": list(sys.path)}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_SRC, env.get("PYTHONPATH")) if p)
        for rank in range(world):
            with open(job / f"rank{rank}.log", "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.spawn",
                     str(job), str(rank)], stdout=log,
                    stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                r = bad[0]
                raise RuntimeError(
                    f"rank {r} of {world} exited {codes[r]}:\n"
                    f"{_tail(job / f'rank{r}.log')}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world} ranks still running after {timeout} s; rank 0 "
                    f"said:\n{_tail(job / 'rank0.log')}")
            time.sleep(0.02)
        out = []
        for rank in range(world):
            with open(job / f"rank{rank}.out", "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(job, ignore_errors=True)


def _rank_main(job: Path, rank: int) -> None:
    """One rank: join the group, run the function, write its result."""
    with open(job / "job.pkl", "rb") as f:
        spec = pickle.load(f)
    sys.path[:] = spec["path"] + [p for p in sys.path
                                  if p not in spec["path"]]
    import torch
    import torch.distributed as dist
    world, backend = spec["world"], spec["backend"]
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    store = dist.FileStore(str(job / "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        dist.barrier()
        result = _resolve(spec["fn"])(*spec["args"])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    tmp = job / f"rank{rank}.out.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, job / f"rank{rank}.out")


if __name__ == "__main__":
    _rank_main(Path(sys.argv[1]), int(sys.argv[2]))
