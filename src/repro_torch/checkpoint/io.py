"""Atomic (de)serialisation in the JAX package's npz layout: the
counterpart of ``repro.checkpoint.io``, so checkpoints cross packages.

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors, numpy arrays or numbers; an ``nn.Module`` or a
:class:`NamedParams` in it (the parameters, AdamW's moments) is laid out
as JAX lays out the parameter tree, each layer's leaf a row of its
segment's ``(count, ...)`` stack.  Keys are JAX's: dict keys, list
indices and a NamedTuple's fields as ``.name``, joined by ``/`` (so
``{"params": lm, "opt": OptState(...)}`` gives ``params/segments/0/attn/wq``
and ``opt/.m/embed``).  Leaves npz cannot hold (bfloat16, fp8) are
stored as unsigned views with their dtype in the ``__meta__`` sidecar,
and decoded with torch views: nothing here needs ``ml_dtypes``.  The file
is written to a temporary name and renamed, so a reader never sees a
partial checkpoint.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import (NamedParams, load_reference,
                                        stack_on_host)

# dtypes numpy lacks, stored as unsigned views of their width
_TORCH_ONLY = {"bfloat16": torch.bfloat16}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _TORCH_ONLY[_name] = getattr(torch, _name)
_SIGNED = {1: np.int8, 2: np.int16, 4: np.int32}
_SIGNED_TORCH = {1: torch.int8, 2: torch.int16, 4: torch.int32}

Flat = Dict[str, np.ndarray]


def _join(prefix: str, key: Any) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _is_params(node: Any) -> bool:
    return isinstance(node, (torch.nn.Module, NamedParams))


def _children(node: Any):
    """(key, child) of a container in JAX's order and naming, or None for
    a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _host_array(t: Any, copy: bool = True) -> Tuple[np.ndarray, str]:
    """A host copy of a leaf (``copy=False``: ``t`` is one already) as
    npz can hold it, and its dtype's name."""
    if not isinstance(t, torch.Tensor):
        arr = np.array(t)
        return arr, str(arr.dtype)
    if copy:
        t = torch.empty(t.shape, dtype=t.dtype).copy_(t.detach())
    name = str(t.dtype).replace("torch.", "")
    if name in _TORCH_ONLY:
        arr = t.view(_SIGNED_TORCH[t.element_size()]).numpy()
        return arr.view(np.dtype(f"u{t.element_size()}")), name
    return t.numpy(), name


def flatten(tree: Any, prefix: str = "") -> Tuple[Flat, Dict[str, str]]:
    """Host copies of every leaf of ``tree`` under JAX's keys, and the
    dtype sidecar.  The copies are taken now: parameters updated in
    place afterwards do not change them."""
    flat: Flat = {}
    dtypes: Dict[str, str] = {}

    def put(key: str, leaf: Any, copy: bool = True) -> None:
        flat[key], dtypes[key] = _host_array(leaf, copy)

    def walk(node: Any, key: str) -> None:
        if _is_params(node):
            for path, t in stack_on_host(node).items():
                put(_join(key, "/".join(map(str, path))), t, copy=False)
            return
        kids = _children(node)
        if kids is None:
            put(key, node)
            return
        for k, child in kids:
            walk(child, _join(key, k))

    walk(tree, prefix)
    return flat, dtypes


def write_flat(path: str | Path, flat: Flat, dtypes: Dict[str, str],
               meta: Optional[dict] = None) -> None:
    """Publish ``flat`` at ``path`` atomically (temporary file, rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"meta": meta or {}, "dtypes": dtypes}
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(payload).encode(), dtype=np.uint8), **flat)
        os.replace(tmp, path)          # atomic publish
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_pytree(path: str | Path, tree: Any, meta: Optional[dict] = None
                ) -> None:
    flat, dtypes = flatten(tree)
    write_flat(path, flat, dtypes, meta)


def _decode(arr: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    if dtype in _TORCH_ONLY:
        t = torch.from_numpy(arr.view(_SIGNED[arr.dtype.itemsize]))
        return t.view(_TORCH_ONLY[dtype])
    if dtype is not None and str(arr.dtype) != dtype:
        arr = arr.view(np.dtype(dtype))
    return torch.from_numpy(arr)


def read_flat(path: str | Path) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Every leaf of the checkpoint at ``path`` as a host tensor of its
    saved dtype, keyed as written, and the metadata."""
    with np.load(Path(path), allow_pickle=False) as z:
        payload = json.loads(bytes(z["__meta__"].tobytes()).decode() or "{}")
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    meta = payload.get("meta", payload)
    dtypes = payload.get("dtypes", {})
    return {k: _decode(a, dtypes.get(k)) for k, a in arrays.items()}, meta


def _fetch(flat: Dict[str, torch.Tensor], key: str) -> torch.Tensor:
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    return flat[key]


def restore(like: Any, flat: Dict[str, torch.Tensor], prefix: str = ""
            ) -> Any:
    """``like`` filled from ``flat``: tensors (an ``LM``'s and AdamW's
    included) are overwritten in place, cast to their own dtype;
    numpy and number leaves are replaced by the stored arrays."""
    if _is_params(like):
        load_reference(like, lambda path: _fetch(
            flat, _join(prefix, "/".join(map(str, path)))))
        return like
    kids = _children(like)
    if kids is None:
        arr = _fetch(flat, prefix)
        shape = tuple(like.shape) if hasattr(like, "shape") else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch for {prefix}: "
                             f"{tuple(arr.shape)} vs {shape}")
        if isinstance(like, torch.Tensor):
            with torch.no_grad():
                like.copy_(arr.to(like.dtype))
            return like
        if isinstance(like, np.ndarray):
            return arr.numpy().astype(like.dtype)
        return type(like)(arr.item())
    new = [(k, restore(child, flat, _join(prefix, k))) for k, child in kids]
    if isinstance(like, dict):
        return type(like)(new)
    if hasattr(like, "_fields"):
        return type(like)(*(v for _, v in new))
    return type(like)(v for _, v in new)


def load_pytree(path: str | Path, like: Any) -> Tuple[Any, dict]:
    """Restore the checkpoint at ``path`` into the structure of ``like``
    (:func:`restore`); returns (tree, metadata)."""
    flat, meta = read_flat(path)
    return restore(like, flat), meta
