"""The compiler's three ring templates on Hopper: counted wrappers over
``csrc/ring_gather.cu``, ``csrc/ring_deref.cu`` and ``csrc/ring_chase.cu``,
and their plain PyTorch versions.

The counterparts of ``repro.kernels.compiled.kernel``:

* :func:`ring_gather` — a STATIC address stream, ``out[k] = port[addrs[k]]``
  over any (N, W) int32/float32 port.  It shares its CUDA body with
  ``gather_rif`` (:func:`~repro_torch.kernels.dae_gather.kernel.ring_rows`).
* :func:`ring_deref` — one INDIRECT hop: ``va = a[addrs]`` then
  ``vb = b[clip(va + offset, 0, NB-1)]``, two rings in one CTA with the
  landed scalars banked in shared memory between them.
* :func:`ring_chase` — a DEPENDENT stream: the lock-step chase of a
  ChaseSpec, which the kernel runs as the register program
  ``repro_torch.compile.chase`` traced from the spec's callables.

The CUDA sources say what bounds each kernel and how the design answers.
As in the reference, items need not be padded here: each kernel's last
CTA takes the ragged rest (the compiler pads all the same, with row 0
and with copies of item 0, and slices the pad off).  Indices are
clamped into the port, as the clipped tail loads of the reference are.
CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  This module does not import ``repro_torch.compile``: the chase
program arrives as an object with the traced ``words`` and the
callables they were traced from.
"""

from __future__ import annotations

import ctypes
from typing import Any, Tuple

import torch

from repro_torch.kernels.common import (check_operands, check_status,
                                        counted, load_library, ring_depth,
                                        stream_ptr)
from repro_torch.kernels.dae_gather.kernel import \
    gather_rif_plain as ring_gather_plain
from repro_torch.kernels.dae_gather.kernel import ring_rows
from repro_torch.kernels.ring import MAX_RIF

__all__ = ["ring_gather", "ring_gather_plain", "ring_deref",
           "ring_deref_plain", "ring_chase", "ring_chase_plain",
           "PORT_DTYPES", "MAX_DEREF_CHUNK"]

PORT_DTYPES = (torch.int32, torch.float32)   # what elaborate stages
MAX_DEREF_CHUNK = 8192        # the address bank's words in shared memory


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
    """Two-phase ring: ``va = a[addrs]`` then ``vb = b[va + offset]``
    (clipped into ``[0, NB)``).  ``port_a`` is (NA, 1) int32, ``port_b``
    (NB, WB) int32 or float32, ``addrs`` (M,) int32; returns
    ((M, 1) int32, (M, WB))."""
    tensors = (port_a, port_b, addrs)
    if all(t.device.type == "cpu" for t in tensors):
        return ring_deref_plain(port_a, port_b, addrs, offset=offset)
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
               [_P] * 5 + [_LL] * 5 + [_I] * 3 + [_P])
    span = min(chunk, m)
    rif_a = min(rif_a, span)
    pitch = -(-wb * 4 // 16) * 16
    rif_b = ring_depth(lib, rif_b, pitch, span, port_b.device,
                       extra_bytes=4 * (rif_a + chunk))
    status = lib.ring_deref_rows(
        port_a.data_ptr(), port_b.data_ptr(), addrs.data_ptr(),
        out_a.data_ptr(), out_b.data_ptr(), na, nb, wb, m, int(offset),
        chunk, rif_a, rif_b, stream_ptr(port_b.device))
    check_status(lib, status, "ring_deref_rows")
    ring_deref.launches += 1
    return out_a, out_b


# ---------------------------------------------------------------------------
# shape 3: DEPENDENT stream
# ---------------------------------------------------------------------------


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


@counted
def ring_chase(port: torch.Tensor, state0_flat: torch.Tensor, program: Any,
               *, rif: int, max_steps: int, s_width: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk a dependent-load chase for M items: ``port`` (N, W) int32,
    ``state0_flat`` the row-major (M*S,) int32 initial state, ``program``
    a :class:`~repro_torch.compile.chase.ChaseProgram` traced for S and
    W.  Returns per-item ``(store_addr, store_value)`` int32 vectors.

    A CTA is 128 threads x ``rif`` items: each thread keeps its items'
    ``rif`` row loads in flight per level, and the last CTA takes the
    ragged rest of M."""
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
    copied = (port,) if w % 4 == 0 else ()
    check_operands((port, state0_flat), copied=copied, dtypes=(torch.int32,))
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
    words = program.staged.get(dev)
    if words is None:
        words = program.staged[dev] = torch.from_numpy(program.words).to(dev)
    lib = _lib("ring_chase", "ring_chase_items",
               [_P, _LL, _I, _P, _P, _P, _LL, _I, _I, _I, _P, _I, _I, _I, _P])
    status = lib.ring_chase_items(
        port.data_ptr(), port.shape[0], w, state0_flat.data_ptr(),
        out_addr.data_ptr(), out_val.data_ptr(), m, s_width, rif, max_steps,
        words.data_ptr(), words.numel(), program.n_instr, program.n_regs,
        stream_ptr(dev))
    check_status(lib, status, "ring_chase_items")
    ring_chase.launches += 1
    return out_addr, out_val
