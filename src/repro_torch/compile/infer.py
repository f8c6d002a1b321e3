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
``csrc/ring.cuh`` waits on.  A chase on the shared-memory path of
``csrc/ring_chase.cuh`` (wider than its register path) is planned at
rif 1 (``chase_plan_rif``: there warps, not items a thread, hide the
row loads), and a rif from the caller or the tune cache is clamped to
what a warp's region holds in the H100's 227 KB (``chase_rif_cap``); a
chase on its streamed path (rows too wide for that region, or of
``STREAM_ROW`` words and more) is planned at ``STREAM_DEPTH`` windows in
flight, the depth ``tools/ring_sweep.py bptree`` found fastest and the
one depth a program's library holds, to which a rif from the caller or
the tune cache is clamped.
So ``describe()`` states the depth that launches.  Each clamp is
recorded as a note.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.compile.ir import ChaseSpec, DaeIR
from repro_torch.core.pipeline import SMEM_OPTIN_BYTES, plan_rif
from repro_torch.kernels.common import dispatch_config
from repro_torch.kernels.compiled.kernel import (chase_path,
                                                 chase_plan_rif,
                                                 chase_rif_cap)
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
                device=None,
                chase: Optional[ChaseSpec] = None) -> Dict[str, ChannelPlan]:
    """One :class:`ChannelPlan` per load channel in ``ir``; ``device``
    (``None``: the card) picks the tune cache's backend; ``chase``, the
    program's ChaseSpec if it has one, sizes its channel's cap."""
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
        if chase is not None and c.port == chase.port:
            s_w = chase.state_width
            path = chase_path(s_w, width)
            cap = chase_rif_cap(s_w, width)
            best = chase_plan_rif(s_w, width, rf)
            if rf_src == "plan_rif" and best < rf:
                notes.append(f"rif {rf} planned down to {best}: " + (
                    "on the chase's shared-memory path warps, not items "
                    "a thread, hide the row loads" if path == "smem" else
                    f"on the chase's streamed path {best} "
                    f"window{'s' if best > 1 else ''} of a warp's rows in "
                    f"flight time{'' if best > 1 else 's'} best"))
                rf = best
            elif cap < rf:
                notes.append(f"rif {rf} clamped to {cap}: " + (
                    f"the chase's shared-memory path holds 32 x {cap} "
                    f"rows of {width} words a warp in {SMEM_OPTIN_BYTES} "
                    f"bytes" if path == "smem" else
                    f"the chase's streamed path keeps {cap} "
                    f"window{'s' if cap > 1 else ''} of a warp's rows in "
                    f"flight"))
                rf = cap
        rf = max(1, min(rf, ck))

        src = rf_src if rf_src == ck_src else f"{rf_src}/{ck_src}"
        plans[c.name] = ChannelPlan(channel=c.name, chunk=ck, rif=rf,
                                    source=src, note="; ".join(notes))
    return plans
