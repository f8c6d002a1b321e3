"""Decoupled merge of sorted runs on Hopper: the counted wrapper over
``csrc/dae_merge.cu`` and its plain PyTorch version.

Replaces ``repro.kernels.dae_merge.kernel.merge_tiles`` (with
``bitonic_merge_first_half``).  The TPU kernel reads its windows from
runs padded with ``tile`` sentinels; here each tile carries the end of
its run (``ends_a``, ``ends_b``) and positions at or past it read as the
sentinel, so the runs need no padded copy and one launch can merge every
pair of runs of a merge-sort pass.  The CUDA source says what bounds it
and how the design answers.  The ring depth is explicit ``rif`` or
``plan_rif`` over one pair of windows, clamped by
:func:`~repro_torch.kernels.common.ring_depth` to a CTA's
``TILES_PER_CTA`` tiles.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.common import (check_operands, check_status,
                                        counted, load_library, ring_depth,
                                        sentinel, stream_ptr)

__all__ = ["merge_tiles", "merge_tiles_plain", "bitonic_merge_first_half",
           "MAX_TILE", "TILES_PER_CTA", "KEY_DTYPES"]

MAX_TILE = 1024           # dae_merge.cu kMaxTile: one thread per output
TILES_PER_CTA = 8         # consecutive tiles one CTA streams through its ring
KEY_DTYPES = (torch.int32, torch.float32)


def _lib() -> ctypes.CDLL:
    lib = load_library("dae_merge")
    if lib.dae_merge_tiles.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dae_merge_tiles.argtypes = [p, p, p, p, p, p, p, ll, i, i, i, i,
                                        i, p]
        lib.dae_merge_tiles.restype = i
    return lib


def bitonic_merge_first_half(v: torch.Tensor) -> torch.Tensor:
    """Given v = concat(sorted_a, reversed(sorted_b)) of length 2T along
    the last dimension (a bitonic sequence), return its sorted first half
    (the T smallest), by the reference's min/max network."""
    n = v.shape[-1]
    lead = v.shape[:-1]
    d = n // 2
    while d >= 1:
        w = v.reshape(*lead, n // (2 * d), 2, d)
        lo = torch.minimum(w[..., 0, :], w[..., 1, :])
        hi = torch.maximum(w[..., 0, :], w[..., 1, :])
        v = torch.stack([lo, hi], dim=-2).reshape(*lead, n)
        d //= 2
    return v[..., : n // 2]


def _windows(x: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
             tile: int) -> torch.Tensor:
    """(n_tiles, tile) windows x[s : s + tile], sentinels at or past e."""
    idx = starts.long()[:, None] + torch.arange(tile, device=x.device)
    big = torch.full(idx.shape, sentinel(x.dtype), dtype=x.dtype,
                     device=x.device)
    if x.numel() == 0:
        return big
    vals = x[idx.clamp(0, x.numel() - 1)]
    return torch.where(idx < ends.long()[:, None], vals, big)


def merge_tiles_plain(a: torch.Tensor, b: torch.Tensor,
                      starts_a: torch.Tensor, ends_a: torch.Tensor,
                      starts_b: torch.Tensor, ends_b: torch.Tensor,
                      n_out: int, *, tile: int) -> torch.Tensor:
    """The same function in plain PyTorch: gather every window pair and
    run the bitonic network on all tiles at once."""
    wa = _windows(a, starts_a, ends_a, tile)
    wb = _windows(b, starts_b, ends_b, tile)
    merged = bitonic_merge_first_half(torch.cat([wa, wb.flip(-1)], dim=-1))
    return merged.reshape(-1)[:n_out]


@counted
def merge_tiles(a: torch.Tensor, b: torch.Tensor, starts_a: torch.Tensor,
                ends_a: torch.Tensor, starts_b: torch.Tensor,
                ends_b: torch.Tensor, n_out: int, *, tile: int,
                rif: Optional[int] = None) -> torch.Tensor:
    """a, b 1-D int32 or float32 sorted runs (or one tensor holding many
    runs, passed as both); starts_* / ends_* (n_tiles,) int32 merge-path
    window starts and the ends of the runs they lie in, in elements.
    Output tile t is the ``tile`` smallest of its two windows;
    returns (n_out,) with n_out <= n_tiles * tile.  ``tile`` a power of
    two.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    splits = (starts_a, ends_a, starts_b, ends_b)
    if all(t.device.type == "cpu" for t in (a, b, *splits)):
        return merge_tiles_plain(a, b, *splits, n_out, tile=tile)
    check_operands((a, b), splits, dtypes=KEY_DTYPES)
    n_tiles = starts_a.shape[0]
    for t in splits:
        if t.dtype != torch.int32 or t.shape != (n_tiles,):
            raise ValueError(f"splits must be ({n_tiles},) int32 tensors")
    if not 2 <= tile <= MAX_TILE or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two in [2, {MAX_TILE}], "
                         f"got {tile}")
    if not 0 <= n_out <= n_tiles * tile:
        raise ValueError(f"n_out {n_out} exceeds {n_tiles} tiles of {tile}")
    out = torch.empty((n_out,), dtype=a.dtype, device=a.device)
    if n_tiles == 0:
        return out
    lib = _lib()
    per_cta = min(TILES_PER_CTA, n_tiles)
    rif = ring_depth(lib, rif, 2 * tile * 4, per_cta, a.device,
                     extra_bytes=tile * 4)
    status = lib.dae_merge_tiles(
        a.data_ptr(), b.data_ptr(), *(t.data_ptr() for t in splits),
        out.data_ptr(), n_out, n_tiles, tile, per_cta, rif,
        int(a.dtype == torch.float32), stream_ptr(a.device))
    check_status(lib, status, "dae_merge_tiles")
    merge_tiles.launches += 1
    return out
