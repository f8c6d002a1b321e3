"""Merge-path splits and the public merge / sort wrappers: the
counterpart of ``repro.kernels.dae_merge.ops``.

``method="kernel"`` (JAX's ``"pallas"``) runs ``merge_tiles`` on CUDA
tensors and its plain version on CPU tensors; ``method="ref"`` is the
oracle.  ``merge_sorted``'s knobs left ``None`` resolve explicit → tune
cache (keyed on (N, M) and the dtype, as the reference keys them) →
analytic: ``tile`` 256; ``rif`` (spans in flight) to ``merge_tiles``'s
measured default, whose ring holds spans of many tiles rather than the
reference's one window pair.

``merge_sort`` differs from the reference in how it drives the merge
unit, not in what it returns: the reference merges each pair of runs by
its own ``merge_sorted`` call from a Python loop (65,535 calls for 2^24
elements at tile 256); here each pass computes the splits of every pair
in one vectorised search and merges them all in one ``merge_tiles``
launch, each window bounded by its own run's end.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.common import (cdiv, refuse_autograd, round_up,
                                        sentinel, tuned_knobs)
from repro_torch.kernels.dae_merge import kernel as _k
from repro_torch.kernels.dae_merge.ref import merge_ref, sort_ref

__all__ = ["merge_path_splits", "merge_sorted", "merge_sort"]


def _lowest(dtype: torch.dtype):
    return float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min


def _method(method: str) -> str:
    if method not in ("kernel", "ref"):
        raise ValueError(f"unknown method {method!r}")
    return method


def _split_search(xa, a0, na, xb, b0, nb, ks, total: int) -> torch.Tensor:
    """For each diagonal k, the number of elements taken from run A
    (``xa[a0 : a0 + na]``) among the first k of merge(A, B), ties taken
    from A first: the smallest i in [max(0, k - nb), min(k, na)] with
    A[i] > B[k - i - 1], found by the reference's binary search.  Runs
    may be per diagonal (tensors) or shared (ints); ``total`` bounds
    every na + nb and sets the number of steps."""
    lo = (ks - nb).clamp(min=0)
    hi = torch.minimum(ks, torch.as_tensor(na, device=ks.device))
    big = torch.tensor(sentinel(xa.dtype), dtype=xa.dtype, device=ks.device)
    low = torch.tensor(_lowest(xb.dtype), dtype=xb.dtype, device=ks.device)
    last_a, last_b = max(xa.numel() - 1, 0), max(xb.numel() - 1, 0)
    for _ in range(max(1, math.ceil(math.log2(max(total, 2))) + 1)):
        mid = (lo + hi) // 2
        av = torch.where(mid < na, xa[(a0 + mid).clamp(0, last_a)], big)
        bk = ks - mid - 1
        bv = torch.where(bk >= 0, xb[(b0 + bk).clamp(0, last_b)], low)
        take_a = av <= bv          # a[mid] <= b[k-mid-1]: split right of mid
        lo = torch.where((lo < hi) & take_a, mid + 1, lo)
        hi = torch.where((lo <= hi) & ~take_a, torch.minimum(hi, mid), hi)
    return lo


def _nonempty(x: torch.Tensor) -> torch.Tensor:
    """``x``, or one sentinel where it is empty (a gather needs a row)."""
    return x if x.numel() else x.new_full((1,), sentinel(x.dtype))


def merge_path_splits(a: torch.Tensor, b: torch.Tensor, tile: int,
                      n_tiles: int):
    """For each output diagonal k = t * tile, (ia, ib) int32: how many of
    the first k merged elements come from ``a`` and from ``b`` (ties take
    from a first)."""
    n, m = a.shape[0], b.shape[0]
    ks = torch.arange(n_tiles, dtype=torch.int64, device=a.device) * tile
    ia = _split_search(_nonempty(a), 0, n, _nonempty(b), 0, m, ks, n + m)
    return ia.to(torch.int32), (ks - ia).to(torch.int32)


def merge_sorted(a: torch.Tensor, b: torch.Tensor, *,
                 tile: Optional[int] = None, rif: Optional[int] = None,
                 method: str = "kernel") -> torch.Tensor:
    """Merge two sorted 1-D tensors (the decoupled merge-path kernel)."""
    if a.dtype != b.dtype:
        raise TypeError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if _method(method) == "ref":
        return merge_ref(a, b)
    refuse_autograd("merge_sorted", a, b)
    n, m = a.shape[0], b.shape[0]
    if tile is None or rif is None:
        knobs = tuned_knobs("dae_merge", (n, m), a.dtype, a.device,
                            tile=(tile, 256), rif=(rif, None))
        tile, rif = knobs["tile"], knobs["rif"]
    # the reference's clamp: no larger than the merge, a power of two
    tile = min(tile, 1 << max(1, (n + m - 1).bit_length()))
    tile = 1 << (tile.bit_length() - 1)
    n_tiles = cdiv(n + m, tile)
    ia, ib = merge_path_splits(a, b, tile, n_tiles)
    ea = torch.full_like(ia, n)
    eb = torch.full_like(ib, m)
    return _k.merge_tiles(a.contiguous(), b.contiguous(), ia, ea, ib, eb,
                          n + m, tile=tile, rif=rif)


def merge_sort(x: torch.Tensor, *, tile: int = 256,
               method: str = "kernel") -> torch.Tensor:
    """Bottom-up merge sort built from the decoupled merge unit (the
    paper's mergesort benchmark): sort tiles, then one pass per doubling
    of the run width, ping-ponging between buffers (mergesort_opt, §4.1).
    The output equals the reference's."""
    if _method(method) == "ref":
        return sort_ref(x)
    refuse_autograd("merge_sort", x)
    n = x.shape[0]
    padded = round_up(n, tile)
    xp = torch.cat([x, x.new_full((padded - n,), sentinel(x.dtype))])
    xp = torch.sort(xp.reshape(-1, tile), dim=1).values.reshape(-1)
    n_tiles = padded // tile
    k_glob = torch.arange(n_tiles, dtype=torch.int64, device=x.device) * tile
    width = tile
    while width < padded:
        # tile t lies in the pair of runs starting at a0: A = [a0, a0 + na),
        # B = [a0 + width, a0 + width + nb), nb = 0 for a run without a pair
        a0 = k_glob // (2 * width) * (2 * width)
        ks = k_glob - a0
        na = (padded - a0).clamp(max=width)
        b0 = a0 + width
        nb = (padded - b0).clamp(0, width)
        ia = _split_search(xp, a0, na, xp, b0, nb, ks, 2 * width)
        i32 = torch.int32
        xp = _k.merge_tiles(xp, xp, (a0 + ia).to(i32), (a0 + na).to(i32),
                            (b0 + ks - ia).to(i32), (b0 + nb).to(i32),
                            padded, tile=tile)
        width *= 2
    return xp[:n]
