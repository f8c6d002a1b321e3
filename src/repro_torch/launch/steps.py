"""Prefill step: the counterpart of ``repro.launch.steps.make_prefill_step``.

The sharded wrappers, ``make_serve_step`` and ``make_train_step`` wait
for later slices.
"""

from __future__ import annotations

from typing import Callable, Dict, Union

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build_model


def make_prefill_step(cfg: ModelConfig,
                      device: Union[None, str, torch.device] = None
                      ) -> Callable:
    """``prefill_step(params, batch) -> (B, V)`` float32 logits at the
    last position of ``batch["tokens"]`` (B, S), through the cache-free
    forward (``ModelBundle.apply``).  Runs on ``cuda`` unless ``device``
    says otherwise."""
    bundle = build_model(cfg, device)

    def prefill_step(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            logits = bundle.apply(params, batch["tokens"])
        return logits[:, -1, :].float()

    return prefill_step
