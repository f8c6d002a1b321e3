"""Plain PyTorch oracles for the decoupled merge: the counterpart of
``repro.kernels.dae_merge.ref``."""

from __future__ import annotations

import torch


def merge_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two sorted 1-D tensors into one sorted tensor."""
    return torch.sort(torch.cat([a, b])).values


def sort_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x).values
