"""Shared helpers for the port's CUDA kernel layer.

The counterpart of ``repro.kernels.common``.  Three concerns live here:

* the integer helpers every wrapper shares (``cdiv``, ``round_up``,
  ``env_flag``) and device resolution: an entry point runs on ``cuda``
  unless its caller asks for ``"cpu"``, and raises when it was given no
  device and the machine has no card;
* the build: every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
  into its own shared library under ``build/repro_torch/`` at first use
  (one ``nvcc`` per source, all started together) and loaded with
  ``ctypes``; a library is rebuilt when its source or a header is newer
  or when the flags stamped beside it differ from :data:`NVCC_FLAGS`.  A
  generated source (a chase program's kernel) goes through
  :func:`load_generated` into ``build/repro_torch/chase/`` under a name
  that hashes its content and the flags, so a second load builds
  nothing.  Each C
  entry point returns ``cudaGetLastError()``; :func:`check_status`
  raises on anything but 0;
* launch counters: every kernel wrapper is a :class:`counted` function
  whose ``launches`` attribute grows by one per kernel launch, so a run
  can show that its main path went through the kernels;
* :func:`refuse_autograd`: the kernels have no backward, so every
  dispatcher refuses, on the card and on the CPU alike, an operand that
  autograd would differentiate through it, as JAX's ``value_and_grad``
  raises through ``pallas_call``.

Knobs resolve as the reference's do (:func:`tuned_knobs`): an explicit
caller value wins; a ``None`` knob takes the ``repro_torch.tune`` cache's
winner for (op, dims, dtype, :func:`backend_tag`); on a miss the
analytic default applies (``plan_rif``, see :func:`ring_rif` and
:func:`ring_depth`, or the wrapper's measured default).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.core.pipeline import SMEM_BUDGET_FRACTION, plan_rif
from repro_torch.kernels.ring import MAX_RIF, clamp_rif
from repro_torch.tune.cache import default_cache, make_key

__all__ = ["cdiv", "round_up", "env_flag", "sentinel", "resolve_device",
           "counted", "refuse_autograd", "load_library", "build_kernels",
           "load_generated",
           "GENERATED_DIR", "GENERATED_BUILDS", "check_status",
           "stream_ptr", "launch", "sm_count", "ring_depth", "ring_rif",
           "check_operands", "ELEM_BYTES", "CSRC", "BUILD_DIR", "NVCC_FLAGS",
           "backend_tag", "dispatch_config", "tuned_knobs", "check_ignored"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# <repo>/build/repro_torch: src/repro_torch/kernels/common.py -> parents[3]
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# the float types the attention and expert kernels instantiate
ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def env_flag(name: str) -> Optional[bool]:
    """Parse a boolean environment variable: unset -> None; empty, "0",
    "false", "no", "off" (any case) -> False; anything else -> True."""
    raw = os.environ.get(name)
    if raw is None:
        return None
    return raw.strip().lower() not in ("", "0", "false", "no", "off")


def sentinel(dtype: torch.dtype):
    """The largest value of ``dtype`` (+inf for floats): the padding that
    sorts after every real element."""
    return float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means the card.  Without a card only an explicit CPU
    request is honoured: the port never continues on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class counted:
    """Decorator for a kernel wrapper: ``fn.launches`` is a plain int the
    wrapper adds one to right after its kernel launched, and nowhere
    else."""

    def __init__(self, fn: Callable):
        functools.update_wrapper(self, fn)
        self._fn = fn
        self.launches = 0

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def refuse_autograd(op: str, *operands) -> None:
    """Raise ``NotImplementedError`` when gradients are on and an operand
    of ``op`` requires one: a kernel writes into a buffer autograd does
    not see, so every parameter upstream would get no gradient, without
    a word.  Called by each dispatcher before its plain/kernel split."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in operands):
        raise NotImplementedError(
            f"{op}: the kernels have no backward (nor do the reference's "
            "Pallas kernels); differentiate with kernel_mode='ref' (or "
            "method='ref')")


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def _flags() -> str:
    return " ".join(NVCC_FLAGS)


def _stamp(lib: Path) -> Path:
    """The file beside ``lib`` naming the flags it was built with."""
    return lib.with_suffix(".flags")


def _stale(src: Path, lib: Path) -> bool:
    """True if ``lib`` is missing, older than its source or a header, or
    was built with other flags than :data:`NVCC_FLAGS`."""
    stamp = _stamp(lib)
    if not lib.exists() or not stamp.exists():
        return True
    if stamp.read_text() != _flags():
        return True
    newest = max([src.stat().st_mtime]
                 + [h.stat().st_mtime for h in CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def _write_whole(path: Path, text: str) -> None:
    """Write ``text`` to ``path`` through a temporary file in the same
    directory and a rename, so a reader never sees a partial file."""
    fd, tmp = tempfile.mkstemp(suffix=path.suffix, dir=path.parent)
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def build_kernels(names=None) -> float:
    """Compile ``csrc/<name>.cu`` (all sources by default) into
    ``BUILD_DIR/lib<name>.so`` where missing or older than its sources,
    one ``nvcc`` per source, all started together.  Returns the seconds
    spent; raises with the compiler's output if any build fails."""
    srcs = sorted(CSRC.glob("*.cu")) if names is None else \
        [CSRC / f"{n}.cu" for n in names]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in srcs:
        lib = BUILD_DIR / f"lib{src.stem}.so"
        if not _stale(src, lib):
            continue
        # write under a temporary name and rename, so a concurrent
        # loader never maps a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", tmp, str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, lib)
            _write_whole(_stamp(lib), _flags())
        else:
            os.unlink(tmp)
            errors.append(f"nvcc {src.name} exited {proc.returncode}:\n{out}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def _open(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    # every library exports csrc/exports.cuh
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    lib.repro_smem_optin.argtypes = [ctypes.c_int]
    lib.repro_smem_optin.restype = ctypes.c_int
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_kernels([name])
            lib = _LIBS[name] = _open(BUILD_DIR / f"lib{name}.so")
        return lib


# the generated sources (the chase programs' kernels) and their libraries
GENERATED_DIR = BUILD_DIR / "chase"
# seconds of every generated library built by this process, by name
GENERATED_BUILDS: Dict[str, float] = {}


def load_generated(name: str, source: str) -> ctypes.CDLL:
    """The loaded library of a generated CUDA source: ``source`` is
    written to ``GENERATED_DIR/<name>.cu`` (through a temporary file and
    a rename, so ``nvcc`` never reads a file another process is still
    writing) and compiled, with the flags of :func:`build_kernels` and
    ``csrc/`` on the include path, into ``lib<name>.so`` unless that
    exists.  ``name`` must hash the source, the headers it includes and
    :data:`NVCC_FLAGS`.  Raises with ``nvcc``'s output if the build
    fails; the seconds of each build go to :data:`GENERATED_BUILDS`."""
    key = f"generated/{name}"
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is not None:
            return lib
        out_dir = GENERATED_DIR
        path = out_dir / f"lib{name}.so"
        if not path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            src = out_dir / f"{name}.cu"
            _write_whole(src, source)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc {src} exited {proc.returncode}:\n"
                                   f"{proc.stdout}")
            os.replace(tmp, path)
            GENERATED_BUILDS[name] = time.perf_counter() - t0
        lib = _LIBS[key] = _open(path)
        return lib


def check_status(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and ``synchronize`` would not report it)."""
    if status != 0:
        msg = lib.repro_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(entry: Callable[..., int], device: torch.device, *args) -> int:
    """Call the C entry point ``entry`` with ``args`` and ``device``'s
    current stream, with ``device`` the current card while it runs: the
    C side sets kernel attributes and launches on the current device, so
    a launch for ``cuda:1`` made while ``cuda:0`` is current would
    otherwise fail.  Returns the entry point's status.  Every kernel
    wrapper launches through this function."""
    with torch.cuda.device(device):
        return entry(*args, stream_ptr(device))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of the card ``device`` lies on."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Every index of ``t``'s first dimension is one contiguous block,
    the blocks at least a block apart (``cache[:, h0:h1]`` of a
    contiguous cache)."""
    inner = t[0] if t.shape[0] else t
    return (t.dim() >= 1 and inner.is_contiguous()
            and (t.shape[0] <= 1 or t.stride(0) >= inner.numel()))


def check_operands(data, others=(), copied=(), dtypes=ELEM_BYTES,
                   batch_strided=()) -> None:
    """Raise unless every tensor lies on one CUDA device and is
    contiguous (a ``batch_strided`` one: contiguous within each index of
    its first dimension, :func:`_rows_contiguous`), the ``data`` tensors
    share one of ``dtypes`` (float32 or bfloat16 unless the kernel takes
    others), and the tensors the kernel copies with ``cp.async`` (16
    bytes at a time) start 16-byte aligned, a batch-strided one's rows
    too."""
    tensors = [*data, *others]
    dev = data[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("all tensors must lie on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    dtype = data[0].dtype
    if dtype not in dtypes or any(t.dtype != dtype for t in data):
        raise TypeError(f"operands must share one of {list(dtypes)}, got "
                        f"{[t.dtype for t in data]}")
    strided = {id(t) for t in batch_strided}
    if not all(t.is_contiguous() or (id(t) in strided
                                     and _rows_contiguous(t))
               for t in tensors):
        raise ValueError("tensors must be contiguous")
    if any(t.data_ptr() % 16 or (id(t) in strided and t.dim()
                                 and (t.stride(0) * t.element_size()) % 16)
           for t in copied):
        raise ValueError("tensors read with cp.async must be 16-byte "
                         "aligned")


def ring_rif(rif: Optional[int], block_bytes: int) -> int:
    """A dispatcher's ring depth: explicit ``rif``, else ``plan_rif`` over
    one request of ``block_bytes`` (the last tier of the explicit →
    analytic order; the kernel wrapper's :func:`ring_depth` then clamps
    it to the stream and to the card's shared memory)."""
    return plan_rif(block_bytes).rif if rif is None else rif


def ring_depth(lib: ctypes.CDLL, rif: Optional[int], stage_bytes: int,
               n_stages: int, device: torch.device, extra_bytes: int = 0,
               plan_bytes: Optional[int] = None) -> int:
    """Depth of a kernel's shared-memory ring of ``stage_bytes`` stages
    over a stream of ``n_stages``: explicit ``rif``, else ``plan_rif``
    over ``plan_bytes`` requests (default: one stage) with half of what
    the card lets one block opt into as budget; then clamped to the
    stream, to ``MAX_RIF`` and to what fits beside the kernel's other
    ``extra_bytes`` of shared memory."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    optin = lib.repro_smem_optin(index)
    if optin <= 0:
        raise RuntimeError("could not read the card's shared-memory opt-in")
    if rif is None:
        rif = plan_rif(plan_bytes or stage_bytes,
                       smem_budget=int(optin * SMEM_BUDGET_FRACTION)).rif
    rif = min(clamp_rif(rif, n_stages), MAX_RIF)
    fits = (optin - extra_bytes) // stage_bytes
    if fits < 1:
        raise ValueError(f"one ring stage of {stage_bytes} bytes does not fit "
                         f"{optin} bytes of shared memory")
    return min(rif, fits)


@functools.lru_cache(maxsize=None)
def _capability(index: int) -> str:
    major, minor = torch.cuda.get_device_capability(index)
    return f"cuda:sm{major}{minor}"


def backend_tag(device) -> str:
    """The tune cache's backend for ``device``: ``cuda:sm90`` on an H100
    (the card's compute capability), ``torch:cpu`` on the CPU.  ``None``
    means the card, and raises without one, as :func:`resolve_device`."""
    if isinstance(device, torch.device) and (device.type == "cpu" or (
            device.type == "cuda" and device.index is not None)):
        dev = device     # a tensor's device: no need to ask for a card
    else:
        dev = resolve_device(device)
    if dev.type == "cpu":
        return "torch:cpu"
    return _capability(dev.index if dev.index is not None
                       else torch.cuda.current_device())


def dispatch_config(op: str, dims, dtype, device,
                    mem: str = "wallclock") -> Dict:
    """Cache-only lookup for a kernel dispatcher — never raises, never
    searches; ``{}`` on a miss, or where ``device`` names no backend
    (``None`` without a card), so callers fall back to their analytic
    default."""
    try:
        cache = default_cache()
        if not len(cache):           # no winner at all: skip the key
            return {}
        hit = cache.get(make_key(op, dims, dtype, backend_tag(device), mem))
        return dict(hit.config) if hit is not None else {}
    except Exception:
        return {}


def tuned_knobs(op: str, dims, dtype, device, **defaults):
    """Resolve a dispatcher's ``None`` knobs: tune-cache winner first,
    caller-supplied analytic default second.

    ``defaults`` maps knob name -> (caller value, fallback); a caller
    value of ``None`` means "not specified".  Returns the filled dict.
    """
    cfg = dispatch_config(op, dims, dtype, device)
    return {k: (v if v is not None else cfg.get(k, fb))
            for k, (v, fb) in defaults.items()}


def check_ignored(**knobs) -> None:
    """The check a reference knob with no Hopper counterpart still gets
    (a block size: a positive int, or ``None``) before it is ignored."""
    for name, value in knobs.items():
        if value is not None and (not isinstance(value, int) or value < 1):
            raise ValueError(f"{name} must be a positive int, got {value!r}")
