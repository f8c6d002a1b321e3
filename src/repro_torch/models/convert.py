"""Move parameters between the JAX package's layout and the port's.

``params_from_numpy(cfg, tree)`` takes the JAX param pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``: layer leaves stacked
``(count, ...)`` per segment, expert weights ``(count, E, D, F)``) and
returns the port's :class:`LM` holding the same values, so both packages
compute the same function.  Tied embeddings have no ``unembed`` leaf.
:func:`params_to_numpy` is its reverse, for an ``LM`` or for any mapping
keyed by its parameter names (gradients, AdamW's moments).

Dense matrix weights are stored in ``dtype``, by default ``cfg.dtype``.
JAX keeps them in ``param_dtype`` and casts with ``.astype(cfg.dtype)``
at every use, which yields the same values, so the results are
bit-identical; at qwen3-4b's full width in bfloat16 this halves the
weights' memory.  Training passes ``dtype=cfg.pdtype`` (JAX's float32
masters).  The embedding table stays in ``param_dtype``, as the gather
reads it there and casts the gathered rows.

The port names a parameter ``segments.<segment>.<layer>.attn.wq``; JAX
holds it at ``segments/<segment>/attn/wq``, row ``<layer>`` of the
segment's stack (:func:`reference_key`).  The encoder-decoder's stacks
are ``enc`` and ``dec``: ``dec.<layer>.xattn.wq`` is row ``<layer>`` of
JAX's ``dec/xattn/wq``; its ``embed``, ``enc_norm``, ``final_norm`` and
``unembed`` are single leaves.  A config with ``qkv_bias`` carries the
float32 ``bq``/``bk``/``bv`` leaves of every attention.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM

Path = Tuple[Union[str, int], ...]


class NamedParams(dict):
    """Tensors keyed by the port's parameter names (``nn.Module.
    named_parameters``): gradients and AdamW's moments.  The checkpoint
    writer lays it out as JAX lays out the parameter tree."""


def named(tree: Union[torch.nn.Module, Mapping[str, torch.Tensor]]
          ) -> Mapping[str, torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return tree


def reference_key(name: str) -> Tuple[Path, Optional[int]]:
    """JAX's tree path of the port parameter ``name`` and the row of the
    segment's stack it sits at (``None`` outside the stacks):
    ``segments.0.3.attn.wq`` -> ``(("segments", 0, "attn", "wq"), 3)``,
    ``dec.3.xattn.wq`` -> ``(("dec", "xattn", "wq"), 3)``."""
    parts = name.split(".")
    if parts[0] == "segments":
        return ("segments", int(parts[1]), *parts[3:]), int(parts[2])
    if parts[0] in ("enc", "dec"):
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


def stack_on_host(tree: Union[torch.nn.Module, Mapping[str, torch.Tensor]]
                  ) -> Dict[Path, torch.Tensor]:
    """Host copies of ``tree``'s tensors in JAX's layout, keyed by JAX's
    path: each layer leaf copied into its row of a new ``(count, ...)``
    stack.  Every tensor is a fresh copy, so the result does not change
    when the parameters are updated in place."""
    rows: Dict[Path, Dict[int, torch.Tensor]] = {}
    out: Dict[Path, torch.Tensor] = {}
    for name, t in named(tree).items():
        path, i = reference_key(name)
        if i is None:
            out[path] = torch.empty(t.shape, dtype=t.dtype).copy_(t.detach())
        else:
            rows.setdefault(path, {})[i] = t
    for path, layers in rows.items():
        first = layers[0]
        buf = torch.empty((len(layers),) + tuple(first.shape),
                          dtype=first.dtype)
        for i, t in layers.items():
            buf[i].copy_(t.detach())
        out[path] = buf
    return out


def nest(flat: Mapping[Path, Any]) -> Dict[str, Any]:
    """``{path: leaf}`` -> JAX's nested tree (``segments`` a list)."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node: Any = tree
        for j, key in enumerate(path[:-1]):
            nxt = path[j + 1]
            if isinstance(node, list):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int)
                                       else {})
        node[path[-1]] = leaf
    return tree


def _leaf(tree: Any, path: Path) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def params_to_numpy(tree: Union[torch.nn.Module, Mapping[str, torch.Tensor]]
                    ) -> Dict[str, Any]:
    """The port's parameters (an ``LM``, or tensors keyed by its
    parameter names) as JAX's stacked tree of numpy arrays; bfloat16
    leaves come out as float32 (numpy has no bfloat16), which holds the
    same values."""
    return nest({path: (t.float() if t.dtype == torch.bfloat16 else t
                        ).numpy()
                 for path, t in stack_on_host(tree).items()})


def load_reference(tree: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                   lookup) -> None:
    """Copy, in place, ``lookup(path)`` (an array or tensor in JAX's
    layout) into every tensor of ``tree``: the row of a layer's leaf,
    the whole of any other; a shape that differs raises ``ValueError``
    naming the leaf."""
    with torch.no_grad():
        for name, t in named(tree).items():
            path, i = reference_key(name)
            arr = lookup(path)
            if i is not None:
                arr = arr[i]
            if not isinstance(arr, torch.Tensor):
                arr = torch.from_numpy(np.array(arr))
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(arr.shape)} != model shape "
                                 f"{tuple(t.shape)}")
            t.copy_(arr.to(t.dtype))


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device: Union[None, str, torch.device] = None,
                      dtype: Optional[torch.dtype] = None
                      ) -> Union[LM, EncDec]:
    """An ``LM`` (an ``EncDec`` for the encoder-decoder) on ``device``
    holding JAX's parameter tree ``tree``, its matrices stored in
    ``dtype`` (default ``cfg.dtype``)."""
    cls = EncDec if cfg.family == "encdec" else LM
    model = cls(cfg, resolve_device(device), dtype=dtype)
    load_reference(model, lambda path: _leaf(tree, path))
    return model
