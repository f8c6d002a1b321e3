"""All-to-all expert-parallel MoE dispatch over a (data, model) rank mesh
(the port's counterpart of ``repro.parallel.ep_dispatch``).

The decoupling principle applied to MoE: move the *request* (the token)
to the data (the expert), with a bounded in-flight window:

  1. each data shard routes its own tokens (top-k);
  2. the routed pairs are binned by destination expert shard under a
     local capacity bound (overflow-free by construction, like the
     paper's §5.1 capacity rule);
  3. one all-to-all along the expert axis moves ~T_loc * k * D values;
  4. each expert shard runs its own experts' FFN (dense ``einsum``, as
     the reference does outside any Pallas kernel);
  5. a reverse all-to-all brings the outputs back, combined with the
     gates at the source.

Routing, the stable sort by destination shard, the capacity bound and
the drops follow the reference step for step, so a tight capacity drops
the same pairs.  Kept standalone (not wired into ``models/moe.py``), as
in the reference.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.parallel.collectives import all_gather, all_to_all
from repro_torch.parallel.sharding import PartitionSpec as P
from repro_torch.parallel.sharding import shard_of

__all__ = ["ep_moe_reference", "make_ep_moe"]


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """Top-k gates (renormalised) and experts of each token."""
    logits = (x @ router).to(torch.float32)
    gates, experts = torch.topk(torch.softmax(logits, -1), top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts


def _ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
         w_down: torch.Tensor) -> torch.Tensor:
    """Every token through every expert: (T, D) -> (T, E, D)."""
    h = F.silu(torch.einsum("td,edf->tef", x, w_gate))
    h = h * torch.einsum("td,edf->tef", x, w_up)
    return torch.einsum("tef,efd->ted", h, w_down)


def ep_moe_reference(x: torch.Tensor, router: torch.Tensor,
                     w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, top_k: int) -> torch.Tensor:
    """One device's oracle: dense top-k MoE, no drops."""
    e = router.shape[1]
    gates, experts = _route(x, router, top_k)
    y_all = _ffn(x, w_gate, w_up, w_down)                    # (T, E, D)
    onehot = F.one_hot(experts, e).to(torch.float32)         # (T, K, E)
    w = (onehot * gates[..., None]).sum(1)                   # (T, E)
    return torch.einsum("ted,te->td", y_all.to(torch.float32),
                        w).to(x.dtype)


def make_ep_moe(mesh, *, ep_axis: str = "model", dp_axis: str = "data",
                top_k: int, n_experts: int, capacity_per_shard: int
                ) -> Callable[..., torch.Tensor]:
    """The expert-parallel MoE apply over the rank mesh ``mesh``:
    ``fn(x, router, w_gate, w_up, w_down)`` takes the whole (T, D)
    tokens and (E, ...) expert weights on every rank, keeps this rank's
    tokens (its ``dp_axis`` block) and experts (its ``ep_axis`` block),
    and returns the whole (T, D) output on every rank (gathered over
    ``dp_axis``; every rank of an ``ep_axis`` line routes the same tokens
    and receives the same results)."""
    n_shards = mesh.shape[ep_axis]
    if n_experts % n_shards:
        raise ValueError(f"{n_experts} experts do not split over "
                         f"{n_shards} shards of {ep_axis!r}")
    e_loc = n_experts // n_shards
    c = capacity_per_shard

    def local_fn(x, router, wg, wu, wd):
        # x (T_loc, D): this rank's tokens; weights (e_loc, ...): its
        # experts
        t_loc, d = x.shape
        dev = x.device
        gates, experts = _route(x, router, top_k)
        flat_e = experts.reshape(-1)                         # (T_loc*K,)
        flat_g = gates.reshape(-1).to(torch.float32)
        flat_t = torch.arange(t_loc, device=dev).repeat_interleave(top_k)
        dest = flat_e // e_loc                               # target shard

        # position of each routed pair within its destination bin
        order = torch.argsort(dest, stable=True)
        sd, se, sg, stk = dest[order], flat_e[order], flat_g[order], \
            flat_t[order]
        starts = torch.searchsorted(
            sd, torch.arange(n_shards, dtype=sd.dtype, device=dev))
        pos = torch.arange(t_loc * top_k, device=dev) - starts[sd]
        keep = pos < c                                       # capacity bound

        # send buffers: (n_shards, C, D) tokens + (n_shards, C) metadata
        send_x = torch.zeros((n_shards, c, d), dtype=x.dtype, device=dev)
        send_le = torch.zeros((n_shards, c), dtype=torch.int32, device=dev)
        send_valid = torch.zeros((n_shards, c), dtype=torch.float32,
                                 device=dev)
        rows = torch.where(keep, sd, 0)
        cols = torch.where(keep, pos, 0)
        send_x[sd[keep], pos[keep]] = x[stk[keep]]
        send_le[sd[keep], pos[keep]] = (se[keep] % e_loc).to(torch.int32)
        send_valid[sd[keep], pos[keep]] = 1.0
        if not bool(keep.all()):
            # the reference scatters every pair, a dropped one as zeros
            # at bin (0, 0) after the kept ones, and a later write wins:
            # a drop zeroes that slot's token and expert, not its flag
            send_x[0, 0] = 0
            send_le[0, 0] = 0

        # all-to-all along the expert axis (the decoupled request stream)
        recv_x = all_to_all(send_x, mesh, ep_axis)
        recv_le = all_to_all(send_le, mesh, ep_axis)
        recv_valid = all_to_all(send_valid, mesh, ep_axis)

        # the local experts' FFN on the (n_shards * C, D) received tokens
        rx = recv_x.reshape(-1, d)
        sel = F.one_hot(recv_le.reshape(-1).long(), e_loc).to(rx.dtype) * \
            recv_valid.reshape(-1)[:, None]
        y_all = _ffn(rx, wg, wu, wd)
        y = torch.einsum("ted,te->td", y_all.to(sel.dtype), sel)

        # send the results back (the decoupled response stream)
        back = all_to_all(y.reshape(n_shards, c, d), mesh, ep_axis)

        # combine at the source with the gates
        contrib = torch.where(keep[:, None], back[rows, cols], 0)
        out = torch.zeros((t_loc, d), dtype=torch.float32, device=dev)
        out.index_add_(0, stk, contrib.to(torch.float32) * sg[:, None])
        return out.to(x.dtype)

    def fn(x, router, w_gate, w_up, w_down):
        experts = P(ep_axis, None, None)
        out = local_fn(shard_of(x, P(dp_axis, None), mesh), router,
                       *(shard_of(w, experts, mesh)
                         for w in (w_gate, w_up, w_down)))
        return all_gather(out, mesh, dp_axis)

    return fn
