"""Feed-forward layers: SwiGLU (llama-style) / plain ReLU/GeLU — the
counterpart of ``repro.models.mlp``.  The matrix products stay plain
``torch.matmul``, as they are plain XLA in JAX."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models.common import ModelConfig, activation, dense_param


class MLP(nn.Module):
    """Weights ``w_gate``/``w_up`` (d_model, d_ff), ``w_down`` (d_ff,
    d_model), stored in ``dtype`` (default ``cfg.dtype``, see
    ``convert.py``); ``d_ff`` defaults to ``cfg.d_ff`` (an MoE's shared
    experts pass their own)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 d_ff: int = 0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        d, f, dt = cfg.d_model, d_ff or cfg.d_ff, dtype or cfg.adtype
        if cfg.mlp_kind == "swiglu":
            self.w_gate = dense_param((d, f), dt, device, generator)
        self.w_up = dense_param((d, f), dt, device, generator)
        self.w_down = dense_param((f, d), dt, device, generator)


def mlp_apply(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.adtype
    if cfg.mlp_kind == "swiglu":
        h = torch.nn.functional.silu(x @ p.w_gate.to(dt)) * (x @ p.w_up.to(dt))
    else:
        h = activation(cfg.mlp_kind, x @ p.w_up.to(dt))
    return h @ p.w_down.to(dt)
