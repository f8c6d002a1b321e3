"""Parallel pointer chasing (paper §4.2, Listings 4 and 5): the
counterpart of ``repro.kernels.dae_chase.ops``.

* ``batched_searchsorted`` is a *block* search: the table is padded
  with sentinels to whole blocks, a ``torch.searchsorted`` over the first
  element of every block (the top of the B-tree, plain XLA in the
  reference) picks each key's block, and ``searchsorted_blocks`` probes
  the blocks with ``rif`` fetches in flight.
* ``hash_lookup`` packs ``(key, val, next)`` into one 16-byte row per
  entry and walks every chain in lock step with ``hash_probe``.

``method="kernel"`` (JAX's ``"pallas"``) runs the Hopper kernels on CUDA
tensors and their plain versions on CPU tensors; ``method="ref"`` is the
oracle.  Knobs left ``None`` resolve explicit → tune cache (keyed on
(N, M) and the table's dtype, int32 for the hash table, as the reference
keys them) → analytic: ``block`` 128, ``chunk`` 64, ``rif`` ``plan_rif``
over one block's bytes.  ``hash_lookup`` takes the reference's ``rif``
and ignores it: every chain of a CTA keeps its load in flight at each
level, so the walk has no ring to size.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import (refuse_autograd, ring_rif, round_up,
                                        sentinel, tuned_knobs)
from repro_torch.kernels.dae_chase import kernel as _k
from repro_torch.kernels.dae_chase.ref import hash_lookup_ref, searchsorted_ref

__all__ = ["batched_searchsorted", "hash_lookup", "pack_entries"]


def _method(method: str) -> str:
    if method not in ("kernel", "ref"):
        raise ValueError(f"unknown method {method!r}")
    return method


def batched_searchsorted(table: torch.Tensor, keys: torch.Tensor, *,
                         block: Optional[int] = None,
                         chunk: Optional[int] = None,
                         rif: Optional[int] = None,
                         method: str = "kernel") -> torch.Tensor:
    """'right' insertion points (M,) int32 of ``keys`` in the sorted 1-D
    ``table`` by decoupled block probes."""
    if _method(method) == "ref":
        return searchsorted_ref(table, keys)
    refuse_autograd("batched_searchsorted", table, keys)
    if keys.dtype != table.dtype:
        raise TypeError(f"keys {keys.dtype} and table {table.dtype} differ")
    n, m = table.shape[0], keys.shape[0]
    if block is None or chunk is None or rif is None:
        knobs = tuned_knobs("batched_searchsorted", (n, m), table.dtype,
                            table.device, block=(block, 128),
                            chunk=(chunk, 64), rif=(rif, None))
        block, chunk, rif = knobs["block"], knobs["chunk"], knobs["rif"]
    rif = ring_rif(rif, block * table.element_size())
    if m == 0:           # no probes, nothing to launch
        return torch.zeros((0,), dtype=torch.int32, device=keys.device)
    padded = round_up(max(n, 1), block)
    tp = table.contiguous()
    if padded != n:
        tp = torch.cat([tp, tp.new_full((padded - n,),
                                        sentinel(table.dtype))])
    tiles = tp.reshape(-1, block)                         # (NB, block)
    # level 0: the block of each key is the last whose first element <= key
    summary = tiles[:, 0].contiguous()
    keys = keys.contiguous()
    blk = (torch.searchsorted(summary, keys, right=True) - 1).clamp_(
        0, tiles.shape[0] - 1).to(torch.int32)
    return _k.searchsorted_blocks(tiles, blk, keys, n,
                                  chunk=min(chunk, max(m, 1)), rif=rif)


def pack_entries(entry_keys: torch.Tensor, entry_vals: torch.Tensor,
                 entry_next: torch.Tensor) -> torch.Tensor:
    """(N, ENTRY_WORDS) int32 rows ``[key, val, next, 0]``; one zero row
    for an empty table, as the reference packs ``max(N, 1)`` rows."""
    n = entry_keys.shape[0]
    packed = torch.zeros((max(n, 1), _k.ENTRY_WORDS), dtype=torch.int32,
                         device=entry_keys.device)
    packed[:n, 0] = entry_keys
    packed[:n, 1] = entry_vals
    packed[:n, 2] = entry_next
    return packed


def hash_lookup(entry_keys: torch.Tensor, entry_vals: torch.Tensor,
                entry_next: torch.Tensor, heads: torch.Tensor,
                keys: torch.Tensor, *, max_steps: int = 16,
                chunk: Optional[int] = None, rif: Optional[int] = None,
                method: str = "kernel") -> torch.Tensor:
    """Lock-step parallel chain walk over a separate-chaining hash table:
    for each lookup, the value of the first entry holding ``keys[i]`` on
    the chain from ``heads[i]``, or -1 if none within ``max_steps``."""
    if _method(method) == "ref":
        return hash_lookup_ref(entry_keys, entry_vals, entry_next, heads,
                               keys, max_steps)
    refuse_autograd("hash_lookup", entry_keys, entry_vals, keys)
    m = heads.shape[0]
    if m == 0:           # no lookups, nothing to launch
        return torch.zeros((0,), dtype=torch.int32, device=heads.device)
    if chunk is None or rif is None:
        chunk = tuned_knobs("hash_lookup", (entry_keys.shape[0], m),
                            torch.int32, heads.device,
                            chunk=(chunk, 64))["chunk"]
    packed = pack_entries(entry_keys, entry_vals, entry_next)
    chunk = min(chunk, m)
    return _k.hash_probe(packed, heads.to(torch.int32).contiguous(),
                         keys.to(torch.int32).contiguous(),
                         max_steps=max_steps, chunk=chunk)
