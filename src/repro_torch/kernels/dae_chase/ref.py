"""Plain PyTorch oracles for the pointer-chasing ops: the counterpart of
``repro.kernels.dae_chase.ref``."""

from __future__ import annotations

import torch


def searchsorted_ref(table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Index of the first element > key (the 'right' insertion point)."""
    return torch.searchsorted(table, keys, right=True).to(torch.int32)


def hash_lookup_ref(entry_keys, entry_vals, entry_next, heads, keys,
                    max_steps: int) -> torch.Tensor:
    """Walk separate-chaining buckets; -1 when not found in ``max_steps``.
    A pointer past the table reads its last entry (the reference clips)."""
    n = entry_keys.shape[0]
    idx = heads.long()
    found = torch.zeros(heads.shape, dtype=torch.bool, device=heads.device)
    val = torch.full(heads.shape, -1, dtype=entry_vals.dtype,
                     device=heads.device)
    for _ in range(max_steps):
        safe = idx.clamp(0, n - 1)
        alive = (idx >= 0) & ~found
        hit = alive & (entry_keys[safe] == keys)
        val = torch.where(hit, entry_vals[safe], val)
        found = found | hit
        idx = torch.where(alive & ~hit, entry_next[safe].long(), idx)
    return torch.where(found, val, torch.full_like(val, -1))
