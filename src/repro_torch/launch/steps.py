"""Train, prefill and serve steps: the counterpart of
``repro.launch.steps``'s ``default_optimizer``, ``make_train_step``,
``make_prefill_step`` and ``make_serve_step``, for every family (the
encoder-decoder's prefill step is its encoder, and its serve step takes
the encoder output).

The sharded wrappers (``shard_train_step`` and the rest) need
collectives across GPUs and wait for the collective half of
multi-device serving; ``launch/mesh.py`` has the meshes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import NamedParams
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamW, warmup_cosine


def default_optimizer(total_steps: int = 10_000) -> AdamW:
    return AdamW(lr=warmup_cosine(3e-4, 200, total_steps), weight_decay=0.1)


def _on(device: torch.device, batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, optimizer: Optional[AdamW] = None,
                    device: Union[None, str, torch.device] = None
                    ) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: the loss and its gradients by autograd
    (``bundle.loss``), then one AdamW update of ``params`` (an ``LM``
    whose matrices are stored in ``cfg.param_dtype``) in place.  The
    batch is numpy or tensors, ``tokens`` and ``labels`` (B, S); the
    metrics are 0-d device tensors (reading them syncs the host).  Runs
    on ``cuda`` unless ``device`` says otherwise.

    In ``kernel`` mode the dispatchers refuse to run under autograd
    (``NotImplementedError``), as JAX's ``pallas`` mode raises under
    ``value_and_grad``: training takes ``kernel_mode="ref"``, and nothing
    switches it silently.  Gradients are dropped after the update, so
    between steps the state holds parameters, m and v only."""
    bundle = build_model(cfg, device)
    opt = optimizer or default_optimizer()

    def train_step(params, opt_state, batch):
        leaves = dict(params.named_parameters())
        low = [k for k, p in leaves.items() if p.dtype != cfg.pdtype]
        if low:
            raise ValueError(
                f"{low[0]} is stored in {leaves[low[0]].dtype}, not "
                f"{cfg.pdtype}: build the trainer's parameters with "
                "dtype=cfg.pdtype (AdamW's updates would round away)")
        params.requires_grad_(True)
        loss = bundle.loss(params, _on(bundle.device, batch))
        loss.backward()
        grads = NamedParams((k, p.grad) for k, p in leaves.items())
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        del grads
        for p in leaves.values():
            p.grad = None
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig,
                      device: Union[None, str, torch.device] = None
                      ) -> Callable:
    """``prefill_step(params, batch) -> (B, V)`` float32 logits at the
    last position of ``batch["tokens"]`` (B, S), through the cache-free
    forward (``ModelBundle.apply``); for the encoder-decoder the encoder
    output (B, S_enc, D) of ``batch["frames"]`` (``ModelBundle.encode``),
    as JAX's returns it.  Runs on ``cuda`` unless ``device`` says
    otherwise."""
    bundle = build_model(cfg, device)

    def prefill_step(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            if cfg.family == "encdec":
                return bundle.encode(params, batch["frames"])
            logits = bundle.apply(params, batch["tokens"])
        return logits[:, -1, :].float()

    return prefill_step


def make_serve_step(cfg: ModelConfig,
                    device: Union[None, str, torch.device] = None
                    ) -> Callable:
    """``serve_step(params, cache, token, pos) -> (logits (B, V) float32,
    cache)``: one decode step on a contiguous cache
    (``ModelBundle.decode_step``), the cache updated in place; the
    encoder-decoder's takes ``enc_out`` last, as JAX's.  Runs on ``cuda``
    unless ``device`` says otherwise."""
    bundle = build_model(cfg, device)

    if cfg.family == "encdec":
        def serve_step(params, cache, token, pos, enc_out):
            with torch.inference_mode():
                return bundle.decode_step(params, enc_out, cache, token, pos)
    else:
        def serve_step(params, cache, token, pos):
            with torch.inference_mode():
                return bundle.decode_step(params, cache, token, pos)

    return serve_step
