"""Plain PyTorch oracle for the decoupled gather kernel."""

from __future__ import annotations

import torch


def gather_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``table`` (N, D) at ``idx`` (M,) -> (M, D)."""
    return table[idx.long()]
