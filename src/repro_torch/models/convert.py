"""Load the JAX package's parameters into the port.

``params_from_numpy(cfg, tree)`` takes the JAX param pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``: layer leaves stacked
``(count, ...)`` per segment, expert weights ``(count, E, D, F)``) and
returns the port's :class:`LM` holding the same values, so both packages
compute the same function.  Tied embeddings have no ``unembed`` leaf.

Dense matrix weights are stored once in ``cfg.dtype``.  JAX keeps them
in ``param_dtype`` and casts with ``.astype(cfg.dtype)`` at every use,
which yields the same values, so the results are bit-identical; at
qwen3-4b's full width in bfloat16 this halves the weights' memory.  The
embedding table stays in ``param_dtype``, as the gather reads it there
and casts the gathered rows.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import LM

# GQA's and MLA's leaves; a layer loads those its attention module has
# (MLA's q_norm is (q_lora_rank,), GQA's (hd,))
_ATTN_KEYS = ("wq", "wk", "wv", "wo", "q_norm", "k_norm",
              "w_dkv", "kv_norm", "w_uk", "w_uv", "w_kr", "w_dq", "w_uq")
_MLP_KEYS = ("w_gate", "w_up", "w_down")
_MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def _put(param: torch.Tensor, arr: Any, name: str) -> None:
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                         f"model shape {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(arr)).to(param.dtype))


def _put_module(module: torch.nn.Module, tree: Dict[str, Any], keys,
                index: int, prefix: str) -> None:
    for key in keys:
        if hasattr(module, key):
            _put(getattr(module, key), tree[key][index], f"{prefix}/{key}")


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device: Union[None, str, torch.device] = None) -> LM:
    model = LM(cfg, resolve_device(device))
    _put(model.embed, tree["embed"], "embed")
    _put(model.final_norm, tree["final_norm"], "final_norm")
    if not cfg.tie_embeddings:
        _put(model.unembed, tree["unembed"], "unembed")
    for si, (layers, seg) in enumerate(zip(model.segments, tree["segments"])):
        for i, layer in enumerate(layers):
            prefix = f"segments/{si}/{i}"
            _put(layer.ln1, seg["ln1"][i], f"{prefix}/ln1")
            _put(layer.ln2, seg["ln2"][i], f"{prefix}/ln2")
            _put_module(layer.attn, seg["attn"], _ATTN_KEYS, i,
                        f"{prefix}/attn")
            if hasattr(layer, "moe"):
                moe = seg["moe"]
                _put_module(layer.moe, moe, _MOE_KEYS, i, f"{prefix}/moe")
                if hasattr(layer.moe, "shared"):
                    _put_module(layer.moe.shared, moe["shared"], _MLP_KEYS, i,
                                f"{prefix}/moe/shared")
            else:
                _put_module(layer.mlp, seg["mlp"], _MLP_KEYS, i,
                            f"{prefix}/mlp")
    return model
