"""Architecture configs the port serves (``get_config(arch)``) and their
smoke variants."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import smoke_variant
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _deepseek
from repro_torch.configs.granite_34b import CONFIG as _granite34
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granite_moe
from repro_torch.configs.minicpm3_4b import CONFIG as _minicpm3
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3
from repro_torch.configs.shapes import SHAPES, InputShape, long_context_ok
from repro_torch.models.common import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    c.arch: c for c in (_deepseek, _granite34, _granite_moe, _minicpm3,
                       _qwen3)}


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    cfg = ARCHS[arch]
    if smoke:
        cfg = smoke_variant(cfg)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


__all__ = ["ARCHS", "SHAPES", "InputShape", "get_config", "long_context_ok",
           "smoke_variant"]
