"""Seeded data at card-filling sizes, shared by ``chip_smoke.py`` and
``tools/ring_sweep.py`` so that both time the kernels on the same
inputs."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["binsearch_data", "BINSEARCH_SIZES"]

# binsearch_data's (table entries, keys)
BINSEARCH_SIZES = (1 << 27, 1 << 22)


def binsearch_data(dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """2^22 keys, half table members and half uniform, in a sorted table
    of 2^27 unique int32 (cumsum of seeded gaps 1-15, 512 MiB)."""
    gen = torch.Generator(device=dev).manual_seed(61)
    n, m = BINSEARCH_SIZES
    table = torch.cumsum(torch.randint(1, 16, (n,), generator=gen, device=dev,
                                       dtype=torch.int32), 0,
                         dtype=torch.int32)
    top = int(table[-1]) + 16
    keys = torch.cat([
        table[torch.randint(0, n, (m // 2,), generator=gen, device=dev)],
        torch.randint(0, top, (m - m // 2,), generator=gen, device=dev,
                      dtype=torch.int32)])
    return table, keys
