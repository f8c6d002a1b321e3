"""Stand-ins for every model input, as tensors on the ``meta`` device (no
allocation): the counterpart of ``repro.launch.specs``, whose
``ShapeDtypeStruct``s these equal in names, shapes and dtypes.

``param_specs(cfg)`` is JAX's parameter tree (layer leaves stacked
``(count, ...)`` per segment); ``train_batch_specs`` the train and
prefill steps' batch; ``decode_arg_specs`` the serve step's cache and
its other arguments.  Modality frontends are stubs, as in the
reference: the encoder-decoder's frames are a dense input.
``meta_model(cfg)`` is the port's own module on ``meta``, keyed by the
port's parameter names, which ``parallel/sharding.py::param_shardings``
rules.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import encdec as _encdec
from repro_torch.models import transformer as _t
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import named, nest, reference_key

META = torch.device("meta")


def meta_model(cfg: ModelConfig, dtype: Optional[torch.dtype] = None
               ) -> torch.nn.Module:
    """The port's model on ``meta``, its matrices in ``dtype`` (default
    ``cfg.param_dtype``, as JAX's parameters are)."""
    cls = _encdec.EncDec if cfg.family == "encdec" else _t.LM
    return cls(cfg, META, dtype=dtype or cfg.pdtype)


def stacked_specs(module) -> Dict[tuple, torch.Tensor]:
    """``{JAX path: meta tensor}``, each layer leaf at its segment
    stack's shape ``(count, ...)``."""
    rows: Dict[tuple, int] = {}
    first: Dict[tuple, torch.Tensor] = {}
    for name, t in named(module).items():
        path, row = reference_key(name)
        if row is None:
            first[path] = t
        else:
            rows[path] = rows.get(path, 0) + 1
            first.setdefault(path, t)
    return {path: (torch.empty((rows[path],) + tuple(t.shape),
                               dtype=t.dtype, device=META)
                   if path in rows else
                   torch.empty(t.shape, dtype=t.dtype, device=META))
            for path, t in first.items()}


def param_specs(cfg: ModelConfig) -> Any:
    """JAX's parameter tree on ``meta`` (``jax.eval_shape`` of
    ``bundle.init``)."""
    return nest(stacked_specs(meta_model(cfg)))


def train_batch_specs(cfg: ModelConfig, shape) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {
        "tokens": torch.empty((b, s), dtype=torch.int32, device=META),
        "labels": torch.empty((b, s), dtype=torch.int32, device=META),
    }
    if cfg.family == "encdec":
        # audio frontend stub: precomputed frame embeddings (enc input);
        # frame count = seq_len (one frame embedding per target position)
        specs["frames"] = torch.empty((b, s, cfg.d_model),
                                      dtype=torch.bfloat16, device=META)
    return specs


def decode_arg_specs(cfg: ModelConfig, shape) -> Tuple[Any, Dict[str, Any]]:
    """(cache_specs, other_arg_specs) for serve_step."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        cache = _encdec.encdec_cache_init(cfg, b, s, META)
    else:
        cache = _t.lm_cache_init(cfg, b, s, META)
    args: Dict[str, Any] = {
        "token": torch.empty((b,), dtype=torch.int32, device=META),
        "pos": torch.empty((b,), dtype=torch.int32, device=META),
    }
    if cfg.family == "encdec":
        args["enc_out"] = torch.empty((b, s, cfg.d_model),
                                      dtype=torch.bfloat16, device=META)
    return cache, args
