"""The collective and op counts of a dry-run cell: the counterpart of
``repro.launch.hlo_stats``.

JAX reads both from the compiled HLO text.  The port compiles nothing,
so no HLO exists; what takes its place is what the step itself issued:

* :func:`collective_stats` takes the
  :class:`~repro_torch.parallel.collectives.Collective` records that
  ``count_collectives`` kept over the step (``parallel/collectives.py``
  is the port's one caller of ``torch.distributed``) and returns JAX's
  record, op for op, under JAX's HLO names: ``all_reduce`` is
  ``"all-reduce"``, ``all_gather`` ``"all-gather"``, ``reduce_scatter``
  ``"reduce-scatter"``, ``all_to_all`` ``"all-to-all"``, ``send``
  ``"collective-permute"``; ``broadcast``, which no HLO op matches and
  no sharded step issues, keeps its own key.  The link bytes are the
  records' own, under JAX's ring model.  A reduce-scatter's payload is
  its *result's* bytes, as JAX reads the result types, where the record
  holds its whole input: the input's bytes over the line's slots.
* :func:`count_ops` takes the aten ops an :class:`OpLog` saw over the
  step and keeps JAX's five keys: ``"dot"`` the matrix products
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``), ``"convolution"``,
  ``"custom-call"`` the port's kernel launches (0 on fake CPU tensors,
  where every wrapper runs its plain version, and under
  ``kernel_mode="ref"``), ``"while"`` 0 (the port has no device loop),
  and ``"fusion"`` every other op that computes.  Views, allocations
  and host reads compute nothing and are left out, as are the
  collectives.

:class:`OpLog` also sums each computing op's input and output bytes:
the dry-run's ``"bytes accessed"``.  That is an unfused count (every op
reads its inputs and writes its outputs), so it is larger than XLA's,
which counts a fusion's operands once.
"""

from __future__ import annotations

import collections
import sys
from typing import Dict, Iterable, Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_HLO_NAMES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
              "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
              "send": "collective-permute", "broadcast": "broadcast"}

_DOTS = frozenset({"mm", "bmm", "addmm", "baddbmm"})
_CONVS = frozenset({"convolution", "convolution_backward"})
# ops that allocate or read a value back: no arithmetic, no traffic
_NO_WORK = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "lift_fresh", "_unsafe_view",
                      "_local_scalar_dense"})


def collective_stats(records: Iterable) -> Dict[str, Dict[str, float]]:
    """JAX's ``collective_stats`` record (``{op: {"count",
    "payload_bytes", "link_bytes"}, "_total": {...}}``) of the
    collectives ``records`` holds, in the order issued."""
    out: Dict[str, Dict[str, float]] = {}
    total_link = 0.0
    for c in records:
        op = _HLO_NAMES[c.kind]
        payload = c.nbytes // c.slots if c.kind == "reduce_scatter" \
            else c.nbytes
        link = c.link_bytes
        d = out.setdefault(op, {"count": 0, "payload_bytes": 0.0,
                                "link_bytes": 0.0})
        d["count"] += 1
        d["payload_bytes"] += payload
        d["link_bytes"] += link
        total_link += link
    out["_total"] = {"count": sum(d["count"] for d in out.values()),
                     "payload_bytes": sum(d["payload_bytes"]
                                          for d in out.values()),
                     "link_bytes": total_link}
    return out


def _nbytes(tensors) -> int:
    seen = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            seen[id(t)] = t.numel() * t.element_size()
    return sum(seen.values())


class OpLog(TorchDispatchMode):
    """Within the block, every aten op that computes (neither a view, an
    allocation, a host read nor a collective) is counted by name in
    ``ops``, and its input and output bytes (elements times element
    size, each tensor once an op) are added to ``bytes``."""

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "aten" and not func.is_view and \
                name not in _NO_WORK:
            self.ops[name] += 1
            self.bytes += _nbytes(tree_leaves((args, kwargs))) + \
                _nbytes(tree_leaves(out))
        return out


def count_ops(ops: Mapping[str, int], launches: int) -> Dict[str, int]:
    """JAX's ``count_ops`` keys, in its order, from ``ops`` (an
    :class:`OpLog`'s counts by aten op name) and ``launches``, the kernel
    launches over the same step (:func:`kernel_launches`)."""
    dots = sum(n for op, n in ops.items() if op in _DOTS)
    convs = sum(n for op, n in ops.items() if op in _CONVS)
    return {"fusion": sum(ops.values()) - dots - convs,
            "custom-call": launches, "while": 0, "dot": dots,
            "convolution": convs}


def kernel_launches() -> int:
    """The launches so far of every kernel wrapper loaded (each a
    ``kernels/common.py::counted``): a wrapper never imported never
    launched."""
    from repro_torch.kernels.common import counted
    wrappers = {id(v): v for name, mod in list(sys.modules.items())
                if name.startswith("repro_torch.kernels.") and mod
                for v in vars(mod).values() if isinstance(v, counted)}
    return sum(v.launches for v in wrappers.values())
