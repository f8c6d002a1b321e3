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
  the register path, anything wider on the shared-memory path, whose
  rows land in a per-warp region of shared memory
  (:func:`chase_warp_bytes`, :func:`chase_rif_cap`).

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
           "chase_smem_warps", "chase_plan_rif"]

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


def chase_rif_cap(s: int, w: int, optin: int = SMEM_OPTIN_BYTES) -> int:
    """The deepest rif the chase kernel takes at state width ``s`` and
    row width ``w``: ``MAX_RIF`` on the register path; on the
    shared-memory path the largest whose warp region fits ``optin``
    bytes (the H100's 227 KB by default), 0 where not even rif 1 does."""
    if chase_register_path(s, w):
        return MAX_RIF
    return max((r for r in range(1, MAX_RIF + 1)
                if chase_warp_bytes(s, w, r) <= optin), default=0)


def chase_plan_rif(s: int, w: int, rif: int) -> int:
    """The depth to launch a chase planned at ``rif``: ``rif`` itself on
    the register path, 1 on the shared-memory path.  There a thread
    steps its items one after another after the level's wait, so warps,
    not items a thread, hide the row loads, and each item a thread adds
    to a warp's region takes shared memory that more warps could use
    (:func:`chase_smem_warps`).  ``tools/ring_sweep.py bptree`` on an
    H100 found rif 1 the fastest depth at rows of 16 to 128 words, and
    the time growing as the warps an SM fall."""
    return rif if chase_register_path(s, w) else min(rif, 1)


def _items(v: Any, m: int, like: torch.Tensor) -> torch.Tensor:
    """A callable's result as an (M,) int32 tensor (a scalar broadcasts,
    a bool becomes 0/1), as the reference's ``astype(jnp.int32)``."""
    if isinstance(v, torch.Tensor):
        v = v.to(torch.int32)
        return v.expand(m) if v.dim() == 0 else v
    return torch.full((m,), int(v), dtype=torch.int32, device=like.device)


def ring_chase_plain(port: torch.Tensor, state0_flat: torch.Tensor,
                     program: Any, *, max_steps: int, s_width: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chase in plain PyTorch: the spec's callables applied to int32
    tensors of all items at once, ``max_steps`` levels, loads clipped."""
    m = state0_flat.shape[0] // s_width
    st = state0_flat.reshape(m, s_width)
    state = tuple(st[:, j] for j in range(s_width))
    n, w = port.shape
    for _ in range(max_steps):
        a = _items(program.addr_fn(state), m, port).long().clamp(0, n - 1)
        rows = port[a]
        row = tuple(rows[:, j] for j in range(w))
        state = tuple(_items(v, m, port)
                      for v in program.step_fn(state, row))
    oa, ov = program.out_fn(state)
    return _items(oa, m, port), _items(ov, m, port)


def _check_chase_smem(lib: ctypes.CDLL, dev: torch.device, s: int, w: int,
                      rif: int) -> None:
    """Raise where one warp's region of the shared-memory path at ``rif``
    does not fit what the card lets one block opt into."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    optin = lib.repro_smem_optin(index)
    if optin <= 0:
        raise RuntimeError("could not read the card's shared-memory opt-in")
    one = chase_warp_bytes(s, w, 1)
    if one > optin:
        raise ValueError(f"one ring stage of {one} bytes (32 rows of {w} "
                         f"int32 and their states) does not fit {optin} "
                         "bytes of shared memory")
    need = chase_warp_bytes(s, w, rif)
    if need > optin:
        raise ValueError(f"ring_chase at rif {rif} needs {need} bytes of "
                         f"shared memory a warp ({32 * rif} rows of {w} "
                         f"int32); {optin} bytes hold rif <= "
                         f"{chase_rif_cap(s, w, optin)}")


def chase_library(program: Any) -> ctypes.CDLL:
    """The kernel library of a traced chase program, built from
    ``program.source()`` under ``build/repro_torch/chase/`` at first use
    and loaded once per process; raises with ``nvcc``'s output if the
    build fails."""
    lib = load_generated(program.library_name(), program.source())
    fn = lib.ring_chase_items
    if fn.argtypes is None:
        fn.argtypes = [_P, _LL, _P, _P, _P, _LL, _I, _I, _P]
        fn.restype = _I
    return lib


@counted
def ring_chase(port: torch.Tensor, state0_flat: torch.Tensor, program: Any,
               *, rif: int, max_steps: int, s_width: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk a dependent-load chase for M items: ``port`` (N, W) int32,
    ``state0_flat`` the row-major (M*S,) int32 initial state, ``program``
    a :class:`~repro_torch.compile.chase.ChaseProgram` traced for S and
    W.  Returns per-item ``(store_addr, store_value)`` int32 vectors.

    Each thread walks ``rif`` items and keeps their ``rif`` rows in
    flight per level: in registers on the register path, in its warp's
    region of shared memory on the shared-memory path, where a ``rif``
    whose region does not fit the card raises with the bytes it needs.
    The last CTA takes the ragged rest of M.  The program's kernel is
    built at its first launch."""
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
    lib = chase_library(program)
    if not chase_register_path(s_width, w):
        _check_chase_smem(lib, dev, s_width, w, rif)
    status = launch(lib.ring_chase_items, dev,
        port.data_ptr(), port.shape[0], state0_flat.data_ptr(),
        out_addr.data_ptr(), out_val.data_ptr(), m, rif, max_steps)
    check_status(lib, status, "ring_chase_items")
    ring_chase.launches += 1
    return out_addr, out_val
