"""The compiler's three ring templates on Hopper: counted wrappers over
``csrc/ring_gather.cu``, ``csrc/ring_deref.cu`` and ``csrc/ring_chase.cuh``
(instantiated per traced program), and their plain PyTorch versions.

The counterparts of ``repro.kernels.compiled.kernel``:

* :func:`ring_gather` — a STATIC address stream, ``out[k] = port[addrs[k]]``
  over any (N, W) int32/float32 port.  It shares its CUDA body with
  ``gather_rif`` (:func:`~repro_torch.kernels.dae_gather.kernel.ring_rows`),
  and takes its bulk form wherever the rows allow it, as ``gather_rif``
  does: on the H100 it was faster at 16- and 128-byte rows than the
  register form (``PERF.md`` §6).
* :func:`ring_deref` — one INDIRECT hop: ``va = a[addrs]`` then
  ``vb = b[clip(va + offset, 0, NB-1)]``: persistent one-warp CTAs whose
  index stream runs ``rif_a`` batches ahead of their rows, the landed
  rows of b banked in shared memory between the two; the rows move
  through the warp's registers, in 16-byte units where the rows allow it
  and in 4-byte units elsewhere (:func:`deref_rows`).
* :func:`ring_chase` — a DEPENDENT stream: the lock-step chase of a
  ChaseSpec of any state and row width, whose callables
  ``repro_torch.compile.chase`` traced and emitted as C++; the program's
  kernel is built at its first launch (:func:`chase_library`).  States
  of at most ``REG_STATE`` words with rows of at most ``REG_ROW`` run on
  the register path; wider programs on the shared-memory path, whose
  rows land in a per-warp region of shared memory
  (:func:`chase_warp_bytes`, :func:`chase_rif_cap`), up to rows of
  ``STREAM_ROW`` words where one warp's 32 rows fit; any other on the
  streamed path, whose rows pass through a warp's window buffers 32
  words at a time (:func:`chase_path`, :func:`chase_stream_bytes`).

The CUDA sources say what bounds each kernel and how the design answers.
As in the reference, items need not be padded here: each kernel's last
CTA takes the ragged rest (the compiler pads all the same, with row 0
and with copies of item 0, and slices the pad off).  Indices are
clamped into the port, as the clipped tail loads of the reference are.
CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  This module does not import ``repro_torch.compile``: the chase
program arrives as an object with its CUDA ``source()``, its
``library_name()`` and the callables it was traced from.
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.pipeline import SMEM_OPTIN_BYTES
from repro_torch.kernels.common import (check_operands, check_status,
                                        counted, load_generated,
                                        launch, load_library, sm_count)
from repro_torch.kernels.dae_gather.kernel import \
    gather_rif_plain as ring_gather_plain
from repro_torch.kernels.dae_gather.kernel import ring_rows
from repro_torch.kernels.ring import MAX_RIF

__all__ = ["ring_gather", "ring_gather_plain", "ring_deref",
           "ring_deref_plain", "ring_chase", "ring_chase_plain",
           "chase_library", "deref_rows", "PORT_DTYPES", "MAX_DEREF_CHUNK",
           "DEREF_CTAS_PER_SM", "REG_STATE", "REG_ROW", "REG_STATE_WORDS",
           "chase_register_path", "chase_warp_bytes", "chase_rif_cap",
           "chase_smem_warps", "chase_plan_rif", "chase_path",
           "chase_stream_built", "chase_stream_bytes", "chase_stream_warps",
           "WINDOW_WORDS", "STREAM_PITCH", "STREAM_ROW", "STREAM_DEPTH",
           "STREAM_MAX_DEPTH", "CHASE_PATHS", "PLAIN_BATCH_BYTES"]

PORT_DTYPES = (torch.int32, torch.float32)   # what elaborate stages
MAX_DEREF_CHUNK = 8192        # items a chunk of the deref's stream
# ring_deref's persistent one-warp CTAs an SM (half the 32 an SM can hold:
# no slower at 128-byte rows, and the register body's 84 registers fit
# 24; PERF.md §6)
DEREF_CTAS_PER_SM = 16


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib(name: str, entry: str, argtypes) -> ctypes.CDLL:
    lib = load_library(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def _check_rif(*rifs: int) -> None:
    for r in rifs:
        if not 1 <= r <= MAX_RIF:
            raise ValueError(f"rif must be in [1, {MAX_RIF}], got {r}")


# ---------------------------------------------------------------------------
# shape 1: STATIC stream
# ---------------------------------------------------------------------------


@counted
def ring_gather(port: torch.Tensor, addrs: torch.Tensor, *, chunk: int,
                rif: int) -> torch.Tensor:
    """Fetch ``port[addrs]``: ``port`` (N, W) int32 or float32, ``addrs``
    (M,) int32.  Returns (M, W)."""
    if port.device.type == "cpu" and addrs.device.type == "cpu":
        return ring_gather_plain(port, addrs)
    _check_rif(rif)
    out = ring_rows(port, addrs, chunk, rif, PORT_DTYPES)
    if out.numel():
        ring_gather.launches += 1
    return out


# ---------------------------------------------------------------------------
# shape 2: one INDIRECT hop
# ---------------------------------------------------------------------------


def ring_deref_plain(port_a: torch.Tensor, port_b: torch.Tensor,
                     addrs: torch.Tensor, *, offset: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same two loads in plain PyTorch (the add in 64 bits)."""
    va = port_a[addrs.long().clamp(0, port_a.shape[0] - 1)]
    vb = port_b[(va[:, 0].long() + offset).clamp(0, port_b.shape[0] - 1)]
    return va, vb


@counted
def ring_deref(port_a: torch.Tensor, port_b: torch.Tensor,
               addrs: torch.Tensor, *, chunk: int, rif_a: int, rif_b: int,
               offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One indirect hop: ``va = a[addrs]`` then ``vb = b[va + offset]``
    (clipped into ``[0, NB)``).  ``port_a`` is (NA, 1) int32, ``port_b``
    (NB, WB) int32 or float32, ``addrs`` (M,) int32; returns
    ((M, 1) int32, (M, WB)).  ``chunk`` items a chunk of a CTA's stream,
    the index stream ``rif_a`` batches of 32 ahead of the rows; ``rif_b``,
    the TPU kernel's row slots, is checked and has no counterpart here
    (the rows move a batch of 32 at a time; :func:`deref_rows`)."""
    tensors = (port_a, port_b, addrs)
    if all(t.device.type == "cpu" for t in tensors):
        return ring_deref_plain(port_a, port_b, addrs, offset=offset)
    out = deref_rows(port_a, port_b, addrs, chunk=chunk, rif_a=rif_a,
                     rif_b=rif_b, offset=offset)
    if addrs.shape[0]:
        ring_deref.launches += 1
    return out


def deref_rows(port_a: torch.Tensor, port_b: torch.Tensor,
               addrs: torch.Tensor, *, chunk: int, rif_a: int, rif_b: int,
               offset: int = 0, _ctas: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check and launch ``ring_deref.cu`` on CUDA tensors: persistent
    one-warp CTAs, ``DEREF_CTAS_PER_SM`` an SM (at most one a chunk),
    each walking every ctas-th chunk; ``tools/ring_sweep.py`` sets the
    CTAs through the private ``_ctas``.  Raises on anything the kernel
    does not take."""
    check_operands((port_b,), (port_a, addrs), dtypes=PORT_DTYPES)
    if port_a.dim() != 2 or port_a.shape[1] != 1 or \
            port_a.dtype != torch.int32:
        raise ValueError("port_a must be an (NA, 1) int32 tensor, got "
                         f"{tuple(port_a.shape)} {port_a.dtype}")
    if port_b.dim() != 2:
        raise ValueError(f"port_b must be (NB, WB), got {tuple(port_b.shape)}")
    if addrs.dim() != 1 or addrs.dtype != torch.int32:
        raise ValueError("addrs must be an (M,) int32 tensor")
    if not 1 <= chunk <= MAX_DEREF_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_DEREF_CHUNK}], got "
                         f"{chunk}")
    _check_rif(rif_a, rif_b)
    na, nb, wb = port_a.shape[0], port_b.shape[0], port_b.shape[1]
    if na < 1 or nb < 1 or wb < 1:
        raise ValueError("ring_deref needs non-empty ports")
    if nb > 2 ** 31:
        raise ValueError(f"port_b has {nb} rows; the address bank is int32")
    m = addrs.shape[0]
    out_a = torch.empty((m, 1), dtype=torch.int32, device=port_b.device)
    out_b = torch.empty((m, wb), dtype=port_b.dtype, device=port_b.device)
    if m == 0:
        return out_a, out_b
    lib = _lib("ring_deref", "ring_deref_rows",
               [_P] * 5 + [_LL] * 5 + [_I] * 2 + [_LL, _P])
    ctas = DEREF_CTAS_PER_SM * sm_count(port_b.device) if _ctas is None \
        else _ctas
    status = launch(lib.ring_deref_rows, port_b.device,
        port_a.data_ptr(), port_b.data_ptr(), addrs.data_ptr(),
        out_a.data_ptr(), out_b.data_ptr(), na, nb, wb, m, int(offset),
        chunk, rif_a, ctas)
    check_status(lib, status, "ring_deref_rows")
    return out_a, out_b


# ---------------------------------------------------------------------------
# shape 3: DEPENDENT stream
# ---------------------------------------------------------------------------

# csrc/ring_chase.cuh's kRegState, kRegRow and kRegStateWords: a program
# of at most REG_STATE state words and REG_ROW row words runs on the
# register path, any other on the shared-memory path, which keeps a
# thread's rif states in registers while they hold at most REG_STATE_WORDS
REG_STATE = 8
REG_ROW = 8
REG_STATE_WORDS = 64


# csrc/ring_chase.cuh's streamed path: kWindowWords, kStreamPitch,
# kStreamRow, kStreamDepth and kStreamMaxDepth.  A launch takes it from
# STREAM_ROW words on and wherever the shared-memory path cannot hold one
# warp's 32 rows (tools/ring_sweep.py bptree, PERF.md §6), at
# STREAM_DEPTH windows in flight a warp, the one depth a program's
# library holds: the fastest at 2048- and 4096-word rows.  The sweep's
# own build holds the path at every width past the register path and
# every depth to STREAM_MAX_DEPTH.
WINDOW_WORDS = 32
STREAM_PITCH = WINDOW_WORDS + 4
STREAM_ROW = 256
STREAM_DEPTH = 1
STREAM_MAX_DEPTH = 4
# ring_chase.cuh's chase::Path, by name
CHASE_PATHS = {"register": 0, "smem": 1, "stream": 2}
# the plain version gathers the rows of at most this many bytes at once
PLAIN_BATCH_BYTES = 1 << 32


def chase_register_path(s: int, w: int) -> bool:
    return s <= REG_STATE and w <= REG_ROW


def _round4(words: int) -> int:
    return -(-words // 4) * 4


def chase_warp_bytes(s: int, w: int, rif: int) -> int:
    """Shared memory of one warp of the shared-memory path
    (``ring_chase.cuh``'s ``warp_smem_bytes``): 32 x ``rif`` rows at a
    bank-spreading pitch, their addresses and, where the states do not
    fit registers, the states at an odd pitch."""
    pitch = (w if (w // 4) % 2 == 1 else w + 4) if w % 4 == 0 else \
        (w if w % 2 == 1 else w + 1)
    items = 32 * rif
    words = _round4(items * pitch) + items
    if s * rif > REG_STATE_WORDS:
        words += _round4(items * (s if s % 2 == 1 else s + 1))
    return 4 * words


# an H100 SM: 228 KB of shared memory, 1 KB of it taken by each resident
# CTA, at most 64 warps and 32 CTAs; the shared-memory path's CTAs hold
# up to CHASE_CTA_WARPS warps (ring_chase.cuh's kThreads / 32)
SM_SMEM_BYTES = 233_472
CTA_RESERVED_BYTES = 1024
SM_MAX_WARPS = 64
SM_MAX_CTAS = 32
CHASE_CTA_WARPS = 4


def chase_smem_warps(s: int, w: int, rif: int,
                     optin: int = SMEM_OPTIN_BYTES) -> Tuple[int, int]:
    """(warps a CTA, warps an SM) of the shared-memory path at ``rif``,
    as far as shared memory decides them: ``launch_smem``'s CTA of up to
    ``CHASE_CTA_WARPS`` warps whose regions fit ``optin``, and as many
    such CTAs as an SM's 228 KB hold.  (0, 0) where one warp does not
    fit."""
    per_warp = chase_warp_bytes(s, w, rif)
    cta = min(optin // per_warp, CHASE_CTA_WARPS)
    if cta == 0:
        return 0, 0
    ctas = min(SM_SMEM_BYTES // (cta * per_warp + CTA_RESERVED_BYTES),
               SM_MAX_CTAS, SM_MAX_WARPS // cta)
    return cta, ctas * cta


def chase_path(s: int, w: int, optin: int = SMEM_OPTIN_BYTES) -> str:
    """The path a chase of state width ``s`` and row width ``w`` takes:
    "register", "smem" where one warp's rif-1 region fits ``optin`` and
    the rows are narrower than ``STREAM_ROW`` words, else "stream"
    (``ring_chase.cuh``'s ``planned_path``)."""
    if chase_register_path(s, w):
        return "register"
    if chase_warp_bytes(s, w, 1) <= optin and w < STREAM_ROW:
        return "smem"
    return "stream"


def chase_stream_built(s: int, w: int, sweep: bool = False) -> bool:
    """Whether a program's library holds the streamed path
    (``ring_chase.cuh``'s ``stream_built``): where it is planned, and in
    the sweep's build wherever the register path is not."""
    return chase_path(s, w) == "stream" or (
        sweep and not chase_register_path(s, w))


def chase_stream_bytes(rif: int) -> int:
    """Shared memory of one warp of the streamed path at ``rif`` windows
    in flight (``ring_chase.cuh``'s ``stream_warp_bytes``): rif + 1
    buffers of a 32-word window of 32 rows, and the rows' numbers."""
    return 4 * ((rif + 1) * 32 * STREAM_PITCH + 32)


def chase_stream_warps(rif: int) -> Tuple[int, int]:
    """(warps a CTA, warps an SM) of the streamed path at ``rif`` as far
    as shared memory decides them: CTAs of ``CHASE_CTA_WARPS`` warps."""
    cta = CHASE_CTA_WARPS
    ctas = min(SM_SMEM_BYTES // (cta * chase_stream_bytes(rif)
                                 + CTA_RESERVED_BYTES),
               SM_MAX_CTAS, SM_MAX_WARPS // cta)
    return cta, ctas * cta


def chase_rif_cap(s: int, w: int, optin: int = SMEM_OPTIN_BYTES) -> int:
    """The deepest rif the chase kernel takes at state width ``s`` and
    row width ``w`` on the path it plans (:func:`chase_path`):
    ``MAX_RIF`` on the register path; on the shared-memory path the
    largest whose warp region fits ``optin`` bytes (the H100's 227 KB by
    default); ``STREAM_DEPTH`` windows on the streamed path, the one
    depth its library holds."""
    path = chase_path(s, w, optin)
    if path == "register":
        return MAX_RIF
    if path == "stream":
        return STREAM_DEPTH
    return max(r for r in range(1, MAX_RIF + 1)
               if chase_warp_bytes(s, w, r) <= optin)


def chase_plan_rif(s: int, w: int, rif: int) -> int:
    """The depth to launch a chase planned at ``rif``: ``rif`` itself on
    the register path, 1 on the shared-memory path and ``STREAM_DEPTH``
    windows on the streamed path.  On the shared-memory
    path a thread steps its items one after another after the level's
    wait, so warps, not items a thread, hide the row loads, and each
    item a thread adds to a warp's region takes shared memory that more
    warps could use (:func:`chase_smem_warps`); ``tools/ring_sweep.py
    bptree`` on an H100 found rif 1 the fastest depth at rows of 16 to
    128 words.  On the streamed path the same sweep times every depth at
    rows of 2048 and 4096 words (``PERF.md`` §6)."""
    path = chase_path(s, w)
    if path == "register":
        return rif
    return STREAM_DEPTH if path == "stream" else 1


def _items(v: Any, m: int, like: torch.Tensor) -> torch.Tensor:
    """A callable's result as an (M,) int32 tensor (a scalar broadcasts,
    a bool becomes 0/1), as the reference's ``astype(jnp.int32)``."""
    if isinstance(v, torch.Tensor):
        v = v.to(torch.int32)
        return v.expand(m) if v.dim() == 0 else v
    return torch.full((m,), int(v), dtype=torch.int32, device=like.device)


def _chase_plain(port: torch.Tensor, st: torch.Tensor, program: Any,
                 max_steps: int, levels: Optional[list]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    m, s_width = st.shape
    state = tuple(st[:, j] for j in range(s_width))
    n, w = port.shape
    for level in range(max_steps):
        a = _items(program.addr_fn(state), m, port).long().clamp(0, n - 1)
        if levels is not None:
            levels[level].append(a)
        rows = port[a]
        row = tuple(rows[:, j] for j in range(w))
        state = tuple(_items(v, m, port)
                      for v in program.step_fn(state, row))
    oa, ov = program.out_fn(state)
    return _items(oa, m, port), _items(ov, m, port)


def ring_chase_plain(port: torch.Tensor, state0_flat: torch.Tensor,
                     program: Any, *, max_steps: int, s_width: int,
                     batch_bytes: int = PLAIN_BATCH_BYTES,
                     levels: Optional[list] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chase in plain PyTorch: the spec's callables applied to int32
    tensors of many items at once, ``max_steps`` levels, loads clipped.
    Items go in batches whose gathered rows hold at most ``batch_bytes``
    (items are independent, so the result is the same).  ``levels``, a
    list of ``max_steps`` lists, receives each batch's row numbers of
    each level."""
    m = state0_flat.shape[0] // s_width
    st = state0_flat.reshape(m, s_width)
    per = max(1, batch_bytes // (4 * port.shape[1]))
    if m <= per:
        return _chase_plain(port, st, program, max_steps, levels)
    outs = [_chase_plain(port, st[i:i + per], program, max_steps, levels)
            for i in range(0, m, per)]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def _check_chase_smem(lib: ctypes.CDLL, dev: torch.device, s: int, w: int,
                      rif: int) -> None:
    """Raise where one warp's region of the shared-memory path at ``rif``
    does not fit what the card lets one block opt into."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    optin = lib.repro_smem_optin(index)
    if optin <= 0:
        raise RuntimeError("could not read the card's shared-memory opt-in")
    need = chase_warp_bytes(s, w, rif)
    if need > optin:
        raise ValueError(f"ring_chase at rif {rif} needs {need} bytes of "
                         f"shared memory a warp ({32 * rif} rows of {w} "
                         f"int32) on the shared-memory path; {optin} bytes "
                         "hold less")


def chase_library(program: Any, sweep: bool = False) -> ctypes.CDLL:
    """The kernel library of a traced chase program, built from
    ``program.source()`` under ``build/repro_torch/chase/`` at first use
    and loaded once per process; raises with ``nvcc``'s output if the
    build fails.  ``sweep`` builds ``tools/ring_sweep.py``'s library
    (``REPRO_CHASE_SWEEP``), which also holds the streamed path's other
    depths and widths."""
    if sweep:
        lib = load_generated(program.library_name() + "_sweep",
                             "#define REPRO_CHASE_SWEEP 1\n" +
                             program.source())
    else:
        lib = load_generated(program.library_name(), program.source())
    fn = lib.ring_chase_items
    if fn.argtypes is None:
        fn.argtypes = [_P, _LL, _P, _P, _P, _LL, _I, _I, _I, _P, _P]
        fn.restype = _I
    return lib


@counted
def ring_chase(port: torch.Tensor, state0_flat: torch.Tensor, program: Any,
               *, rif: int, max_steps: int, s_width: int,
               _path: Optional[str] = None, _sweep: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk a dependent-load chase for M items: ``port`` (N, W) int32,
    ``state0_flat`` the row-major (M*S,) int32 initial state, ``program``
    a :class:`~repro_torch.compile.chase.ChaseProgram` traced for S and
    W.  Returns per-item ``(store_addr, store_value)`` int32 vectors.

    The path is :func:`chase_path`'s.  On the register path each thread
    walks ``rif`` items and keeps their ``rif`` rows in flight per level
    in registers; on the shared-memory path it does so in its warp's
    region of shared memory, where a ``rif`` whose region does not fit
    the card raises with the bytes it needs; on the streamed path each
    lane walks one item and its warp keeps ``rif`` windows of its 32
    rows in flight, where ``rif`` must be ``STREAM_DEPTH``.  The last CTA
    takes the ragged rest of M.  The program's kernel is built at its
    first launch.  ``tools/ring_sweep.py`` names another path through the
    private ``_path`` ("smem" or "stream") and launches its own build,
    every streamed depth to ``STREAM_MAX_DEPTH``, through ``_sweep``."""
    m = state0_flat.shape[0] // max(s_width, 1)
    if state0_flat.dim() != 1 or state0_flat.shape[0] != m * s_width:
        raise ValueError(f"state0_flat of {tuple(state0_flat.shape)} is not "
                         f"(M * {s_width},)")
    if port.dim() != 2:
        raise ValueError(f"port must be (N, W), got {tuple(port.shape)}")
    if program.s_width != s_width or program.row_width != port.shape[1]:
        raise ValueError(
            f"the chase program was traced for S={program.s_width}, "
            f"W={program.row_width}; the call has S={s_width}, "
            f"W={port.shape[1]}")
    if port.device.type == "cpu" and state0_flat.device.type == "cpu":
        return ring_chase_plain(port, state0_flat, program,
                                max_steps=max_steps, s_width=s_width)
    w = port.shape[1]
    check_operands((port, state0_flat), dtypes=(torch.int32,))
    if w in (2, 4, 8) and port.data_ptr() % min(16, 4 * w):
        raise ValueError(f"a port of {w}-word rows must start "
                         f"{min(16, 4 * w)}-byte aligned (vector loads)")
    _check_rif(rif)
    if port.shape[0] < 1:
        raise ValueError("ring_chase needs a non-empty port")
    if max_steps < 0:
        raise ValueError(f"max_steps must be >= 0, got {max_steps}")
    dev = port.device
    out_addr = torch.empty(m, dtype=torch.int32, device=dev)
    out_val = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return out_addr, out_val
    path = chase_path(s_width, w) if _path is None else _path
    if path not in CHASE_PATHS:
        raise ValueError(f"unknown chase path {path!r}")
    if path == "stream":
        if not chase_stream_built(s_width, w, _sweep):
            raise ValueError(f"a chase of S={s_width}, W={w} has no "
                             "streamed path")
        depths = range(1, STREAM_MAX_DEPTH + 1) if _sweep else \
            (STREAM_DEPTH,)
        if rif not in depths:
            raise ValueError(f"the streamed path keeps {STREAM_DEPTH} "
                             f"window{'s' if STREAM_DEPTH > 1 else ''} in "
                             f"flight, got rif {rif}")
    lib = chase_library(program, _sweep)
    if path == "smem":
        _check_chase_smem(lib, dev, s_width, w, rif)
    scratch = None
    if path == "stream" and s_width > REG_STATE_WORDS:
        scratch = torch.empty(-(-m // 32) * 32 * s_width, dtype=torch.int32,
                              device=dev)
    status = launch(lib.ring_chase_items, dev,
        port.data_ptr(), port.shape[0], state0_flat.data_ptr(),
        out_addr.data_ptr(), out_val.data_ptr(), m, rif, max_steps,
        CHASE_PATHS[path], None if scratch is None else scratch.data_ptr())
    check_status(lib, status, "ring_chase_items")
    ring_chase.launches += 1
    return out_addr, out_val
