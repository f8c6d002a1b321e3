"""Feed-forward layers: SwiGLU (llama-style) / plain ReLU/GeLU — the
counterpart of ``repro.models.mlp``.  The matrix products stay plain
``torch.matmul``, as they are plain XLA in JAX.  In a sharded step
``w_gate``/``w_up`` are column-parallel and ``w_down`` row-parallel over
``model``, its partial sums added over ``model`` (Megatron's f and g)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models.common import ModelConfig, activation, dense_param
from repro_torch.parallel.sharding import model_cut, tp_enter, tp_out, use


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


def mlp_apply(cfg: ModelConfig, p: MLP, x: torch.Tensor,
              leave: bool = True) -> torch.Tensor:
    """The MLP of ``x`` (B, S, D), back on the residual stream
    (``tp_out``: summed over ``model`` where ``model`` cuts it, the
    rank's tokens of it on a stream cut along its tokens); with
    ``leave`` False the output as this rank computes it (the MoE's
    shared experts hand theirs to the routed experts' sum)."""
    dt = cfg.adtype
    split = model_cut(p.w_down) is not None
    if split:
        x = tp_enter(x)
    if cfg.mlp_kind == "swiglu":
        h = (torch.nn.functional.silu(x @ use(p.w_gate).to(dt))
             * (x @ use(p.w_up).to(dt)))
    else:
        h = activation(cfg.mlp_kind, x @ use(p.w_up).to(dt))
    y = h @ use(p.w_down).to(dt)
    return tp_out(y, split) if leave else y
