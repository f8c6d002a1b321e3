"""Where a tuned knob meets its kernel.

Each ``KERNEL_DIMS`` op's dispatcher (``kernels/*/ops.py``) calls one or
two counted kernel wrappers through its ``_k`` module: that call is the
op's seam.  :data:`SEAMS` names the wrappers and the knobs each takes,
:func:`seam_knobs` says what a cached winner becomes there after the
dispatcher's clamps, and :func:`spied` runs a call with every wrapper of
an op's seam recorded.  A ``None``-knob dispatch whose wrapper received
``seam_knobs(op, winner, dims)`` ran the winner.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.kernels.ring import MAX_RIF
from repro_torch.tune.cache import Config

__all__ = ["SEAMS", "Spy", "seam_knobs", "spied"]


def _block_keys(tiles, *_args) -> int:
    return tiles.shape[1]


def _block_shape(val_blocks, *_args) -> Tuple[int, int]:
    return tuple(val_blocks.shape[1:])


# op -> (kernel module, {wrapper: (keyword knobs it takes, knobs read
# from its positional operands)})
SEAMS: Dict[str, Tuple[str, Dict[str, Tuple[Tuple[str, ...],
                                            Dict[str, Callable]]]]] = {
    "dae_gather": ("repro_torch.kernels.dae_gather.kernel", {
        "gather_rows": ((), {}), "gather_rif": (("chunk", "rif"), {})}),
    "dae_merge": ("repro_torch.kernels.dae_merge.kernel", {
        "merge_tiles": (("tile", "rif"), {})}),
    "flash_attention": ("repro_torch.kernels.flash_attention.kernel", {
        "flash": (("rif",), {})}),
    "flash_decode": ("repro_torch.kernels.flash_attention.kernel", {
        "flash_decode": (("bk", "rif"), {})}),
    "flash_decode_paged": ("repro_torch.kernels.flash_attention.kernel", {
        "flash_decode_paged": (("rif",), {})}),
    "grouped_matmul": ("repro_torch.kernels.grouped_matmul.kernel", {
        "gmm": (("_bn", "rif"), {})}),
    "batched_searchsorted": ("repro_torch.kernels.dae_chase.kernel", {
        "searchsorted_blocks": (("chunk", "rif"), {"block": _block_keys})}),
    "hash_lookup": ("repro_torch.kernels.dae_chase.kernel", {
        "hash_probe": (("chunk",), {})}),
    "dae_spmv": ("repro_torch.kernels.dae_spmv.kernel", {
        "bsr_spmv": (("rif",), {"block": _block_shape})}),
}


def seam_knobs(op: str, cfg: Config,
               dims: Tuple[int, ...]) -> Tuple[str, Dict[str, Any]]:
    """(wrapper, knobs): what the kernel wrapper receives when ``cfg``
    dispatches ``op`` at ``dims``, after the dispatcher's clamps.  Knobs
    with no Hopper counterpart (``block_d``, ``bq``, ``bd``, the hash
    walk's ``rif``) never reach a wrapper."""
    if op == "dae_gather":
        if cfg["method"] == "pipelined":
            return "gather_rows", {}
        c = min(cfg["chunk"], dims[2])
        return "gather_rif", {"chunk": c, "rif": min(cfg["rif"], MAX_RIF, c)}
    if op == "batched_searchsorted":
        return "searchsorted_blocks", {"chunk": min(cfg["chunk"], dims[1]),
                                       "rif": cfg["rif"],
                                       "block": cfg["block"]}
    if op == "hash_lookup":
        return "hash_probe", {"chunk": min(cfg["chunk"], dims[1])}
    if op == "dae_spmv":
        return "bsr_spmv", {"rif": cfg["rif"],
                            "block": (cfg["bm"], cfg["bk"])}
    if op == "grouped_matmul":
        return "gmm", {"_bn": 128 if cfg["bf"] <= 128 else 256,
                       "rif": cfg["rif"]}
    (wrapper, (keys, _)), = SEAMS[op][1].items()
    return wrapper, {k: cfg[k] for k in keys}


class Spy:
    """Stands in for a counted kernel wrapper at its module's seam:
    records the named knobs of each call and forwards the call, and its
    launch count, to the wrapper."""

    def __init__(self, real: Callable, keys: Tuple[str, ...],
                 derived: Optional[Dict[str, Callable]] = None):
        self.real, self.keys, self.derived = real, keys, derived or {}
        self.calls = []

    def __call__(self, *a, **kw):
        got = {k: kw.get(k) for k in self.keys}
        got.update({k: fn(*a) for k, fn in self.derived.items()})
        self.calls.append(got)
        return self.real(*a, **kw)

    @property
    def launches(self) -> int:
        return self.real.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.real.launches = value


def spied(op: str, run: Callable[[], Any]
          ) -> Tuple[Any, Dict[str, Dict[str, Any]]]:
    """``run()`` with every wrapper of ``op``'s seam spied: (its output,
    {wrapper: the knobs of its last call}) for the wrappers it called."""
    module_name, wrappers = SEAMS[op]
    module = importlib.import_module(module_name)
    spies = {name: Spy(getattr(module, name), keys, derived)
             for name, (keys, derived) in wrappers.items()}
    for name, spy in spies.items():
        setattr(module, name, spy)
    try:
        out = run()
    finally:
        for name, spy in spies.items():
            setattr(module, name, spy.real)
    return out, {name: spy.calls[-1] for name, spy in spies.items()
                 if spy.calls}
