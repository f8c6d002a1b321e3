"""Pass 4 — codegen: instantiate ring kernels + the store epilogue.

The port of ``repro.compile.codegen``.  The checked IR lowers onto the
three templates in :mod:`repro_torch.kernels.compiled`:

  * every surviving STATIC channel   -> one :func:`ring_gather` call;
  * every INDIRECT channel + source  -> one :func:`ring_deref` call
    (the source's landed values come back from phase 1);
  * a ChaseSpec program              -> one :func:`ring_chase` call, on
    the register program :func:`~repro_torch.compile.chase.trace_chase`
    traces from the spec once, here.

What remains on the host is the *store epilogue*: the traced
:class:`~repro_torch.compile.ir.StoreIR` events replayed in program
order, each copy store reading its channel's landed row, each const
store its partially-evaluated value.  That replay is pure bookkeeping —
every byte that moves, moves through a ring on the device.

Where the reference wraps each kernel call in ``jax.jit`` once, codegen
here stages every port and address stream on the device once, so
repeated :meth:`CompiledKernel.__call__`\\ s (the bench loop) copy
nothing to the card.  Address streams are padded to a chunk multiple
with row 0 and chase items with copies of item 0, as in the reference;
the pad is sliced off.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.compile.chase import trace_chase
from repro_torch.compile.check import CheckResult, _norm_value
from repro_torch.compile.infer import ChannelPlan
from repro_torch.compile.ir import ChannelIR, ChaseSpec, DaeIR, StreamKind
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.compiled import ring_chase, ring_deref, ring_gather

__all__ = ["CompiledKernel", "codegen"]


def _padded_addrs(addrs: List[int], chunk: int) -> np.ndarray:
    m = len(addrs)
    mp = -(-m // chunk) * chunk
    out = np.zeros(mp, np.int32)          # pad fetches row 0; sliced off
    out[:m] = addrs
    return out


def _stage(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _host(t: torch.Tensor, m: int) -> np.ndarray:
    return t[:m].cpu().numpy()


def _gather_runner(ir: DaeIR, c: ChannelIR, plan: ChannelPlan,
                   device: torch.device) -> Callable[[], Dict[str, Any]]:
    port_t = _stage(ir.ports[c.port].array, device)
    addrs_t = _stage(_padded_addrs(c.addrs, plan.chunk), device)
    chunk, rif = plan.chunk, plan.rif
    name, m = c.name, c.count

    def run() -> Dict[str, Any]:
        out = ring_gather(port_t, addrs_t, chunk=chunk, rif=rif)
        return {name: _host(out, m)}
    return run


def _deref_runner(ir: DaeIR, src: ChannelIR, c: ChannelIR,
                  src_plan: ChannelPlan, plan: ChannelPlan,
                  device: torch.device) -> Callable[[], Dict[str, Any]]:
    a_t = _stage(ir.ports[src.port].array, device)
    b_t = _stage(ir.ports[c.port].array, device)
    chunk = plan.chunk
    addrs_t = _stage(_padded_addrs(src.addrs, chunk), device)
    rif_a, rif_b, offset = src_plan.rif, plan.rif, c.offset
    names, m = (src.name, c.name), c.count

    def run() -> Dict[str, Any]:
        out_a, out_b = ring_deref(a_t, b_t, addrs_t, chunk=chunk,
                                  rif_a=rif_a, rif_b=rif_b, offset=offset)
        return {names[0]: _host(out_a, m), names[1]: _host(out_b, m)}
    return run


def _chase_runner(ir: DaeIR, spec: ChaseSpec, plan: ChannelPlan,
                  device: torch.device) -> Callable[[], Dict[str, Any]]:
    m, s = spec.n_items, spec.state_width
    chunk = max(1, min(plan.chunk, m))     # plan.chunk sized on requests
    rif = max(1, min(plan.rif, chunk))     # = items x levels; re-clamp
    mp = -(-m // chunk) * chunk
    state0 = np.zeros((mp, s), np.int32)
    state0[:m] = spec.state0.astype(np.int32)
    if mp > m:
        state0[m:] = state0[0]             # pad items shadow item 0
    port = ir.ports[spec.port].array
    program = trace_chase(spec.addr_fn, spec.step_fn, spec.out_fn, s,
                          port.shape[1])
    port_t = _stage(port, device)
    flat_t = _stage(state0.reshape(-1), device)
    max_steps = spec.max_steps

    def run() -> Dict[str, Any]:
        oa, ov = ring_chase(port_t, flat_t, program, rif=rif,
                            max_steps=max_steps, s_width=s)
        return {"__chase__": (_host(oa, m), _host(ov, m))}
    return run


@dataclasses.dataclass
class CompiledKernel:
    """A runnable compiled program: call it, get the output ports.

    ``__call__`` runs every ring kernel (device), then the store
    epilogue (host), and returns ``{out port: np.ndarray}`` — width-1
    ports as 1-D arrays, matching what
    :meth:`SimResult.stored_array`-style oracles produce.
    """

    name: str
    shape: str                              # 'gather' | 'deref' | 'chase'
    ir: DaeIR
    plans: Dict[str, ChannelPlan]
    out_specs: Dict[str, Tuple[int, int, Any]]
    device: torch.device
    chase: Optional[ChaseSpec] = None
    runners: List[Callable[[], Dict[str, Any]]] = \
        dataclasses.field(default_factory=list)
    pass_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __call__(self) -> Dict[str, np.ndarray]:
        landed: Dict[str, Any] = {}
        for run in self.runners:
            landed.update(run())

        outs: Dict[str, np.ndarray] = {}
        for port, (length, width, dtype) in self.out_specs.items():
            arr = np.zeros((length, width), dtype)
            raw = self.ir.raw_memories.get(port)
            if raw is not None:            # numeric initial contents
                for i, v in enumerate(raw):
                    row = _norm_value(v)
                    if row is not None and len(row) == width:
                        arr[i] = row.astype(dtype)
            outs[port] = arr

        if self.shape == "chase":
            if "__chase__" in landed:
                oa, ov = landed["__chase__"]
                out = outs[self.chase.out_port]
                for a, v in zip(oa, ov):
                    out[int(a), 0] = v
        else:
            for st in self.ir.stores:
                if st.source is not None:
                    cname, k = st.source
                    val = landed[cname][k]
                else:                       # const: partially evaluated
                    val = _norm_value(st.value)
                outs[st.port][st.addr] = np.asarray(val).astype(
                    outs[st.port].dtype)

        return {p: (a[:, 0] if a.shape[1] == 1 else a)
                for p, a in outs.items()}

    def describe(self) -> str:
        lines = [f"CompiledKernel({self.name}) shape={self.shape} "
                 f"device={self.device}"]
        for p in self.plans.values():
            lines.append(f"  plan {p.channel}: chunk={p.chunk} "
                         f"rif={p.rif} [{p.source}]"
                         + (f" ({p.note})" if p.note else ""))
        lines.append(self.ir.describe())
        return "\n".join(lines)


def codegen(ir: DaeIR, chk: CheckResult,
            plans: Dict[str, ChannelPlan], *,
            chase: Optional[ChaseSpec] = None,
            device=None) -> CompiledKernel:
    """Instantiate the ring kernels for a checked IR on ``device``
    (``None``: the card)."""
    device = resolve_device(device)
    runners: List[Callable[[], Dict[str, Any]]] = []

    if chk.shape == "chase":
        assert chase is not None
        if ir.channels and chase.n_items > 0:
            (c,) = ir.channels.values()
            runners.append(_chase_runner(ir, chase, plans[c.name], device))
    else:
        consumed = set()
        for c in ir.channels.values():
            if c.kind is StreamKind.INDIRECT and c.count > 0:
                src = ir.channels[c.source]
                runners.append(_deref_runner(
                    ir, src, c, plans[src.name], plans[c.name], device))
                consumed.update((src.name, c.name))
        for c in ir.channels.values():
            if (c.name not in consumed
                    and c.kind is StreamKind.STATIC and c.count > 0):
                runners.append(_gather_runner(ir, c, plans[c.name], device))

    return CompiledKernel(
        name=ir.name, shape=chk.shape, ir=ir, plans=plans,
        out_specs=chk.out_specs, device=device, chase=chase,
        runners=runners)
