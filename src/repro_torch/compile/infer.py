"""Pass 2 — infer: size the rings (chunk + RIF per channel).

The port's copy of ``repro.compile.infer``.  Dispatch order is the
repo-wide contract (see ``tuned_knobs``):

  1. an explicit caller value always wins;
  2. else the ``repro_torch.tune`` cache is consulted under the
     *per-program* key ``compiled:<program name>`` (what
     ``tune_compiled`` persists), for the backend of the device the
     program compiles for;
  3. else ``plan_rif`` sizes the ring analytically from one row's byte
     size (paper §4.2's latency×bandwidth product), and the chunk is 64.

``ChannelPlan.source`` names the tier of each knob.  The resolved RIF is
clamped to the simulated channel's declared *capacity*: §5.3's
deadlock-freedom bound is a property of the program, and the compiled
ring must not keep more copies in flight than the program declared
safe.  It is then clamped to ``MAX_RIF``, the deepest ring
``csrc/ring.cuh`` waits on, so that ``describe()`` states the depth that
launches.  Both clamps are recorded as notes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.compile.ir import DaeIR
from repro_torch.core.pipeline import plan_rif
from repro_torch.kernels.common import dispatch_config
from repro_torch.kernels.ring import MAX_RIF

__all__ = ["ChannelPlan", "infer_plans", "program_key_parts"]


@dataclasses.dataclass
class ChannelPlan:
    """Ring sizing for one compiled channel."""

    channel: str
    chunk: int
    rif: int
    source: str          # 'explicit' | 'cache' | 'plan_rif'
    note: str = ""


def program_key_parts(ir: DaeIR):
    """(op, dims, dtype) identifying this program in the tune cache —
    one key per program (the knobs apply to every ring it emits)."""
    total = sum(c.count for c in ir.channels.values())
    width = max((ir.ports[c.port].width for c in ir.channels.values()
                 if c.port in ir.ports), default=1)
    dtypes = {str(ir.ports[c.port].array.dtype)
              for c in ir.channels.values() if c.port in ir.ports}
    dtype = "float32" if "float32" in dtypes else "int32"
    return f"compiled:{ir.name}", (total, width), dtype


def _cached_config(ir: DaeIR, device) -> Dict:
    op, dims, dtype = program_key_parts(ir)
    return dispatch_config(op, dims, dtype, device)


def infer_plans(ir: DaeIR, *, rif: Optional[int] = None,
                chunk: Optional[int] = None,
                device=None) -> Dict[str, ChannelPlan]:
    """One :class:`ChannelPlan` per load channel in ``ir``; ``device``
    (``None``: the card) picks the tune cache's backend."""
    cfg = {} if (rif is not None and chunk is not None) \
        else _cached_config(ir, device)

    plans: Dict[str, ChannelPlan] = {}
    for c in ir.channels.values():
        port = ir.ports.get(c.port)
        width = port.width if port is not None else 1
        itemsize = port.array.dtype.itemsize if port is not None else 4

        if chunk is not None:
            ck, ck_src = chunk, "explicit"
        elif "chunk" in cfg:
            ck, ck_src = int(cfg["chunk"]), "cache"
        else:
            ck, ck_src = 64, "plan_rif"
        ck = max(1, min(ck, max(c.count, 1)))

        if rif is not None:
            rf, rf_src = rif, "explicit"
        elif "rif" in cfg:
            rf, rf_src = int(cfg["rif"]), "cache"
        else:
            rf, rf_src = plan_rif(width * itemsize).rif, "plan_rif"

        notes: List[str] = []
        if rf > c.capacity:
            notes.append(f"rif {rf} clamped to declared channel "
                         f"capacity {c.capacity} (§5.3 bound)")
            rf = c.capacity
        if rf > MAX_RIF:
            notes.append(f"rif {rf} clamped to the ring's MAX_RIF "
                         f"{MAX_RIF} (ring.cuh waits on at most that many "
                         f"copies)")
            rf = MAX_RIF
        rf = max(1, min(rf, ck))

        src = rf_src if rf_src == ck_src else f"{rf_src}/{ck_src}"
        plans[c.name] = ChannelPlan(channel=c.name, chunk=ck, rif=rf,
                                    source=src, note="; ".join(notes))
    return plans
