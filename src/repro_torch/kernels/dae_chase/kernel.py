"""Decoupled pointer chasing on Hopper: the counted wrappers over
``csrc/dae_chase.cu`` and their plain PyTorch versions.

Replaces ``repro.kernels.dae_chase.kernel.searchsorted_blocks`` and
``hash_probe``.  The CUDA source says what bounds them and how the
designs answer.  Two departures from the TPU wrappers: keys and chains
need no padding to a multiple of ``chunk`` (the last CTA takes fewer),
and a hash entry is one 16-byte row ``[key, val, next, 0]``
(``ENTRY_WORDS``) where the TPU padded it to a 128-lane DMA row.
``searchsorted_blocks`` reads a key's block a 64-byte unit at a time,
searching the units, where the TPU fetched the whole block:
:func:`search_plan` turns the block, ``chunk`` and ``rif`` into the
kernel's levels and keys in flight.  ``hash_probe`` has no ring: every
chain of a CTA has its load in flight at each level, so the TPU's
``rif`` has no counterpart there.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels.common import (cdiv, check_operands, check_status,
                                        counted, launch, load_library,
                                        ring_rif)
from repro_torch.kernels.dae_chase.ref import hash_lookup_ref

__all__ = ["searchsorted_blocks", "searchsorted_blocks_plain", "hash_probe",
           "hash_probe_plain", "search_plan", "SearchPlan", "ENTRY_WORDS",
           "MAX_CHUNK", "KEY_DTYPES", "SEARCH_UNIT_BYTES", "SEARCH_MAX_KPT"]

ENTRY_WORDS = 4           # [key, val, next, 0]: one 16-byte load
MAX_CHUNK = 1024          # dae_chase.cu kMaxChunk
KEY_DTYPES = (torch.int32, torch.float32)    # what the search instantiates
# The search's unit, dae_chase.cu kLanes x 16: the bytes one read of a key
# fetches (on the H100 a random read of up to 64 bytes costs one DRAM
# access: PERF.md §6, tools/ring_sweep.py's `search` part).
SEARCH_UNIT_BYTES = 64
# Keys a lane group keeps in flight at most (dae_chase.cu instantiates 1,
# 2 and 4): 4 keys of 64-byte units take 63 registers a thread, so an SM
# holds 32 one-warp CTAs; 8 take 121 and half as many (PERF.md §6).
SEARCH_MAX_KPT = 4


@dataclass(frozen=True)
class SearchPlan:
    """What the search kernel is launched with: at most ``levels``
    reads of ``SEARCH_UNIT_BYTES`` a key, ``kpt`` keys a lane group (of
    ``SEARCH_UNIT_BYTES / 16`` lanes) keeps in flight, ``ctas`` one-warp
    CTAs of ``chunk`` keys each."""
    levels: int
    kpt: int
    ctas: int


def search_plan(block: int, m: int, chunk: int, rif: int) -> SearchPlan:
    """The host plan of :func:`searchsorted_blocks` for M keys in blocks of
    ``block`` 4-byte elements.  ``levels`` is the bit length of the
    block's unit count (each read at least halves the units left; a block
    smaller than a unit is one unit); ``kpt`` is ``rif`` (at most
    ``SEARCH_MAX_KPT``) rounded down to a power of two, and no more than
    one chunk gives each of a warp's lane groups."""
    levels = cdiv(block, SEARCH_UNIT_BYTES // 4).bit_length()
    groups = 32 * 16 // SEARCH_UNIT_BYTES
    want = max(1, min(rif, SEARCH_MAX_KPT, cdiv(chunk, groups)))
    return SearchPlan(levels, 1 << (want.bit_length() - 1), cdiv(m, chunk))


def _lib() -> ctypes.CDLL:
    lib = load_library("dae_chase")
    if lib.dae_searchsorted_blocks.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dae_searchsorted_blocks.argtypes = [p, p, p, p, ll, i, ll, ll, i,
                                                i, i, i, p]
        lib.dae_searchsorted_blocks.restype = i
        lib.dae_hash_probe.argtypes = [p, p, p, p, ll, ll, i, i, p]
        lib.dae_hash_probe.restype = i
    return lib


def _check_chunk(chunk: int) -> None:
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")


def searchsorted_blocks_plain(tiles: torch.Tensor, blk: torch.Tensor,
                              keys: torch.Tensor, n: int) -> torch.Tensor:
    """The same function in plain PyTorch: gather each key's block and
    count its elements <= key."""
    block = tiles.shape[1]
    within = (tiles[blk.long()] <= keys[:, None]).sum(1)
    return (blk.long() * block + within).clamp(max=n).to(torch.int32)


@counted
def searchsorted_blocks(tiles: torch.Tensor, blk: torch.Tensor,
                        keys: torch.Tensor, n: int, *, chunk: int = 64,
                        rif: Optional[int] = None) -> torch.Tensor:
    """tiles (NB, block) the sorted table padded with +inf/INT_MAX; blk
    (M,) int32 the block holding each key's insertion point; keys (M,) in
    the tiles' dtype (int32 or float32).  Returns (M,) int32 'right'
    insertion points clipped to ``n``.  ``chunk`` keys a CTA; ``rif`` the
    keys each lane group keeps in flight (``None``: ``plan_rif`` over one
    block), through :func:`search_plan`.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if all(t.device.type == "cpu" for t in (tiles, blk, keys)):
        return searchsorted_blocks_plain(tiles, blk, keys, n)
    check_operands((tiles, keys), (blk,), copied=(tiles,), dtypes=KEY_DTYPES)
    _check_chunk(chunk)
    if tiles.dim() != 2 or tiles.shape[1] % 4 or tiles.shape[0] < 1:
        raise ValueError("tiles must be (NB >= 1, block) with block a "
                         f"multiple of 4, got {tuple(tiles.shape)}")
    m = keys.shape[0]
    if keys.dim() != 1 or blk.shape != (m,) or blk.dtype != torch.int32:
        raise ValueError("keys (M,) and blk (M,) int32 expected, got "
                         f"{tuple(keys.shape)} and {tuple(blk.shape)} "
                         f"{blk.dtype}")
    out = torch.empty((m,), dtype=torch.int32, device=tiles.device)
    if m == 0:
        return out
    nb, block = tiles.shape
    chunk = min(chunk, m)
    plan = search_plan(block, m, chunk, ring_rif(rif, block * 4))
    lib = _lib()
    status = launch(lib.dae_searchsorted_blocks, tiles.device,
        tiles.data_ptr(), blk.data_ptr(), keys.data_ptr(), out.data_ptr(),
        nb, block, m, n, chunk, plan.kpt, plan.levels,
        int(tiles.dtype == torch.float32))
    check_status(lib, status, "dae_searchsorted_blocks")
    searchsorted_blocks.launches += 1
    return out


def hash_probe_plain(packed: torch.Tensor, heads: torch.Tensor,
                     keys: torch.Tensor, *, max_steps: int) -> torch.Tensor:
    """The same function in plain PyTorch: the lock-step walk over the
    packed rows' key, value and next columns."""
    return hash_lookup_ref(packed[:, 0], packed[:, 1], packed[:, 2], heads,
                           keys, max_steps).to(torch.int32)


@counted
def hash_probe(packed: torch.Tensor, heads: torch.Tensor, keys: torch.Tensor,
               *, max_steps: int, chunk: int = 64) -> torch.Tensor:
    """packed (N, ENTRY_WORDS) int32 rows ``[key, val, next, 0]``, N >= 1;
    heads / keys (M,) int32.  Returns (M,) int32 values, -1 where the key
    is not found within ``max_steps`` entries.  ``chunk`` chains per CTA.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    if all(t.device.type == "cpu" for t in (packed, heads, keys)):
        return hash_probe_plain(packed, heads, keys, max_steps=max_steps)
    check_operands((packed, heads, keys), copied=(packed,),
                   dtypes=(torch.int32,))
    _check_chunk(chunk)
    if packed.dim() != 2 or packed.shape[1] != ENTRY_WORDS or \
            packed.shape[0] < 1:
        raise ValueError(f"packed must be (N >= 1, {ENTRY_WORDS}), got "
                         f"{tuple(packed.shape)}")
    m = heads.shape[0]
    if heads.dim() != 1 or keys.shape != (m,):
        raise ValueError(f"heads {tuple(heads.shape)} and keys "
                         f"{tuple(keys.shape)} must both be (M,)")
    if max_steps < 0:
        raise ValueError(f"max_steps must be >= 0, got {max_steps}")
    out = torch.empty((m,), dtype=torch.int32, device=packed.device)
    if m == 0:
        return out
    lib = _lib()
    status = launch(lib.dae_hash_probe, packed.device, packed.data_ptr(),
                    heads.data_ptr(), keys.data_ptr(), out.data_ptr(),
                    packed.shape[0], m, chunk, max_steps)
    check_status(lib, status, "dae_hash_probe")
    hash_probe.launches += 1
    return out
