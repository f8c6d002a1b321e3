"""Pass 2 — infer: size the rings (chunk + RIF per channel).

The port's copy of ``repro.compile.infer``.  Dispatch order is the
repo-wide contract, without the tune cache the port does not have yet:

  1. an explicit caller value always wins;
  2. else ``plan_rif`` sizes the ring analytically from one row's byte
     size (paper §4.2's latency×bandwidth product), and the chunk is 64.

So ``ChannelPlan.source`` is ``"explicit"`` or ``"plan_rif"``, never
``"cache"``.  The resolved RIF is clamped to the simulated channel's
declared *capacity*: §5.3's deadlock-freedom bound is a property of the
program, and the compiled ring must not keep more copies in flight than
the program declared safe.  It is then clamped to ``MAX_RIF``, the
deepest ring ``csrc/ring.cuh`` waits on, so that ``describe()`` states
the depth that launches.  Both clamps are recorded as notes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.compile.ir import DaeIR
from repro_torch.core.pipeline import plan_rif
from repro_torch.kernels.ring import MAX_RIF

__all__ = ["ChannelPlan", "infer_plans"]


@dataclasses.dataclass
class ChannelPlan:
    """Ring sizing for one compiled channel."""

    channel: str
    chunk: int
    rif: int
    source: str          # 'explicit' | 'plan_rif'
    note: str = ""


def infer_plans(ir: DaeIR, *, rif: Optional[int] = None,
                chunk: Optional[int] = None) -> Dict[str, ChannelPlan]:
    """One :class:`ChannelPlan` per load channel in ``ir``."""
    plans: Dict[str, ChannelPlan] = {}
    for c in ir.channels.values():
        port = ir.ports.get(c.port)
        width = port.width if port is not None else 1
        itemsize = port.array.dtype.itemsize if port is not None else 4

        if chunk is not None:
            ck, ck_src = chunk, "explicit"
        else:
            ck, ck_src = 64, "plan_rif"
        ck = max(1, min(ck, max(c.count, 1)))

        if rif is not None:
            rf, rf_src = rif, "explicit"
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
