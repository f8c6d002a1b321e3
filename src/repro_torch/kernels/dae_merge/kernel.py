"""Decoupled merge of sorted runs on Hopper: the counted wrapper over
``csrc/dae_merge.cu`` and its plain PyTorch version.

Replaces ``repro.kernels.dae_merge.kernel.merge_tiles`` (with
``bitonic_merge_first_half``).  The TPU kernel reads its windows from
runs padded with ``tile`` sentinels; here each tile carries the end of
its run (``ends_a``, ``ends_b``) and positions at or past it read as the
sentinel, so the runs need no padded copy and one launch can merge every
pair of runs of a merge-sort pass.  The CUDA source says what bounds it
and how the design answers: persistent CTAs stream spans of
:func:`span_tiles` tiles through a ring of ``rif`` stages of
:func:`stage_bytes`, and each thread merges ``MERGE_K`` outputs serially
from its own merge-path split.  ``rif`` left ``None`` is
``DEFAULT_STAGES``, the depth measured fastest on the H100
(``tools/ring_sweep.py merge``: deeper rings cost CTAs an SM and gain no
overlap); any depth is clamped by
:func:`~repro_torch.kernels.common.ring_depth` and to ``MAX_STAGES``.

The merge takes ties from ``a`` first, so float ``-0.0`` and ``+0.0``
land in that order; the plain version is the same stable merge.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.common import (cdiv, check_operands, check_status,
                                        counted, launch, load_library,
                                        ring_depth, round_up, sentinel)

__all__ = ["merge_tiles", "merge_tiles_plain", "span_tiles", "stage_bytes",
           "MAX_TILE", "MAX_SPAN", "MAX_STAGES", "DEFAULT_STAGES", "MERGE_K",
           "CONSUMERS", "KEY_DTYPES"]

# dae_merge.cu's constants
MAX_TILE = 1024           # kMaxTile
MAX_SPAN = 32             # kMaxSpan: tiles a span, a producer lane each
MAX_STAGES = 4            # kMaxStages
DEFAULT_STAGES = 2        # ring stages when rif is None
MERGE_K = 8               # kK: outputs a consumer thread merges
CONSUMERS = 256           # kConsumers: merging threads a CTA
META_BYTES = MAX_STAGES * MAX_SPAN * 16 + 16 + 2 * MAX_STAGES * 8
SPAN_OUTPUTS = 2048       # outputs a span: beat 4096 and 8192 (ring_sweep)
KEY_DTYPES = (torch.int32, torch.float32)


def span_tiles(tile: int) -> int:
    """Tiles a span: ``SPAN_OUTPUTS`` outputs, 1 to ``MAX_SPAN`` tiles."""
    return max(1, min(MAX_SPAN, SPAN_OUTPUTS // tile))


def stage_bytes(tile: int, span: int) -> int:
    """Bytes of one ring stage: the union of a span's windows under
    merge-path splits ((span + 1) tiles of 4-byte keys, and 16-byte
    rounding at each end of two intervals), and at least one round of the
    per-tile path (every consumer's tile's two windows)."""
    kk = min(MERGE_K, tile)
    per_round = CONSUMERS // (tile // kk)
    return round_up(max((span + 1) * tile * 4 + 64,
                        per_round * 2 * tile * 4), 16)


def _lib() -> ctypes.CDLL:
    lib = load_library("dae_merge")
    if lib.dae_merge_tiles.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dae_merge_tiles.argtypes = [p, p, p, p, p, p, p, ll, i, i, i, i,
                                        i, i, p]
        lib.dae_merge_tiles.restype = i
    return lib


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
    merge all tiles at once, ties from a first (the kernel's rule): a
    window element lands at its own index plus the number of the other
    window's elements that go before it."""
    wa = _windows(a, starts_a, ends_a, tile)
    wb = _windows(b, starts_b, ends_b, tile)
    rank = torch.arange(tile, device=wa.device)
    pos_a = rank + torch.searchsorted(wb, wa)             # b strictly less
    pos_b = rank + torch.searchsorted(wa, wb, right=True)  # a less or equal
    merged = torch.empty((wa.shape[0], 2 * tile), dtype=wa.dtype,
                         device=wa.device)
    merged.scatter_(1, pos_a, wa).scatter_(1, pos_b, wb)
    return merged[:, :tile].reshape(-1)[:n_out]


@counted
def merge_tiles(a: torch.Tensor, b: torch.Tensor, starts_a: torch.Tensor,
                ends_a: torch.Tensor, starts_b: torch.Tensor,
                ends_b: torch.Tensor, n_out: int, *, tile: int,
                rif: Optional[int] = None) -> torch.Tensor:
    """a, b 1-D int32 or float32 sorted runs (or one tensor holding many
    runs, passed as both); starts_* / ends_* (n_tiles,) int32 merge-path
    window starts and the ends of the runs they lie in, in elements.
    Output tile t is the ``tile`` smallest of its two windows, whatever
    the starts (starts that are not merge-path splits take the kernel's
    per-tile path); returns (n_out,) with n_out <= n_tiles * tile.
    ``tile`` a power of two; ``rif`` spans in flight.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
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
    span = span_tiles(tile)
    sbytes = stage_bytes(tile, span)
    stages = min(MAX_STAGES, ring_depth(
        lib, DEFAULT_STAGES if rif is None else rif, sbytes,
        cdiv(n_tiles, span), a.device, extra_bytes=META_BYTES))
    status = launch(lib.dae_merge_tiles, a.device,
        a.data_ptr(), b.data_ptr(), *(t.data_ptr() for t in splits),
        out.data_ptr(), n_out, n_tiles, tile, span, stages, sbytes,
        int(a.dtype == torch.float32))
    check_status(lib, status, "dae_merge_tiles")
    merge_tiles.launches += 1
    return out
