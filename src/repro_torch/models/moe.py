"""Mixture-of-experts layer with decoupled dispatch: the counterpart of
``repro.models.moe`` (paper §4.1 analogue).

After top-k routing the token→expert map is CSR-shaped, and the expert
GEMM stream is the decoupled access stream.  Two dispatch paths, as in
JAX:

* ``_dispatch_xla`` (``kernel_mode="ref"``): sort-based
  capacity-bounded dispatch — argsort the (token, expert) pairs by
  expert, place the first C per expert into an (E, C) table,
  batched-einsum all experts and scatter-add back with gate weights;
* ``_dispatch_pallas`` (``kernel_mode="kernel"``): pairs sorted by
  expert and each expert group padded to whole ``bt``-row blocks, then
  the ``grouped_matmul`` kernel streams each block's expert weights.
  It also hands the kernel each block's count of real rows, so blocks
  of pure padding stream no weights.

Both compute the same math up to capacity drops (the kernel path drops
nothing).  In a sharded step the experts are cut over ``model``: the
routing is computed whole on every rank, each rank dispatches only the
pairs routed to its own experts, and the partial outputs are added over
``model``; the shared experts (deepseek's) are cut as a dense MLP, and
their partial sum joins the routed experts' in one float32 sum.  The capacity stays JAX's, of the whole batch: each rank
counts the pairs of its experts that the ranks before it on the batch
axis hold, so a sharded step drops exactly the pairs the unsharded one
drops.  Nothing here syncs with the host: the padded length is the
static bound ``round_up(T*K, bt) + E*bt``, counts come from
``scatter_add_``, not ``bincount``, and the capacity table takes the
dropped pairs in a spare column, not through a boolean mask.  Training
differentiates the ``ref`` path; ``moe_aux_loss`` is the Switch-style
load-balancing loss.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.common import round_up
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.models.common import ModelConfig, dense_param
from repro_torch.models.mlp import MLP, mlp_apply
from repro_torch.parallel.collectives import all_gather
from repro_torch.parallel.sharding import (batch_lines, current_shards,
                                           model_cut, tp_enter, tp_out, use)


class MoE(nn.Module):
    """``router`` (d_model, n_experts); ``w_gate``/``w_up`` (E, d_model,
    F) and ``w_down`` (E, F, d_model) with E the padded expert count; the
    optional ``shared`` MLP.  All stored in ``dtype`` (default
    ``cfg.dtype``) and cast to ``cfg.dtype`` at every use, as JAX casts
    them."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        e, d = cfg.n_experts_padded, cfg.d_model
        f, dt = cfg.moe_d_ff or cfg.d_ff, dtype or cfg.adtype
        self.router = dense_param((d, cfg.n_experts), dt, device, generator)
        self.w_gate = dense_param((e, d, f), dt, device, generator)
        self.w_up = dense_param((e, d, f), dt, device, generator)
        self.w_down = dense_param((e, f, d), dt, device, generator)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, device, generator,
                              d_ff=f * cfg.n_shared_experts, dtype=dt)


def _route(cfg: ModelConfig, p: MoE, x2d: torch.Tensor):
    """x2d (T, D) -> gates (T, K) float32, experts (T, K) int32.  Where
    the experts are cut over ``model``, the replicated router enters
    model-local compute through f (its gradient summed over ``model``)."""
    router = p.router
    if model_cut(p.w_gate) is not None:
        router = tp_enter(router)
    logits = (x2d @ router.to(cfg.adtype)).float()
    gates, experts = torch.topk(torch.softmax(logits, dim=-1), cfg.top_k,
                                dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts.to(torch.int32)


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor, *,
              capacity_factor: float = 0.0) -> torch.Tensor:
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    cut = model_cut(p.w_gate)
    dt = cfg.adtype
    w = tuple(use(t).to(dt) for t in (p.w_gate, p.w_up, p.w_down))
    e0 = 0 if cut is None else cut[2] * w[0].shape[0]
    if cut is not None:     # f: the replicated x, this rank's experts
        x2d = tp_enter(x2d)
    gates, experts = _route(cfg, p, x2d)
    if cfg.kernel_mode == "kernel":
        y2d = _dispatch_pallas(cfg, w, e0, x2d, gates, experts)
    else:
        y2d = _dispatch_xla(cfg, w, e0, x2d, gates, experts,
                            capacity_factor or cfg.capacity_factor)
    y = y2d.reshape(b, s, d)
    if not cfg.n_shared_experts:
        return tp_out(y, cut is not None)
    # cut as a dense MLP (columns and rows, not as experts)
    ys = mlp_apply(cfg, p.shared, x, leave=False)
    shared_cut = model_cut(p.shared.w_down) is not None
    if cut is not None and shared_cut:
        # the two partial sums join in one float32 sum
        return tp_out(y.float() + ys.float(), True).to(dt)
    return tp_out(y, cut is not None) + tp_out(ys, shared_cut)


def _local_pairs(experts: torch.Tensor, e0: int, e: int):
    """:func:`sort_pairs` over this rank's experts ``[e0, e0 + e)``
    numbered from 0; every other pair is sorted into a group ``e`` after
    them.  Also returns whether each (token, k) pair is local."""
    lex = experts - e0
    local = (lex >= 0) & (lex < e)
    return (*sort_pairs(torch.where(local, lex, e), e + 1), local)


def _before(counts: torch.Tensor) -> torch.Tensor:
    """Per local expert, its pairs on the ranks before this one along
    the batch axis (zeros where no axis cuts the batch), and a 0 for the
    group of other ranks' experts."""
    sh = current_shards()
    if batch_lines() == 1:
        return torch.zeros_like(counts)
    rows = all_gather(counts[None, :-1], sh.mesh, sh.batch_axis)
    i = sh.mesh.axis_index(sh.batch_axis)
    out = torch.zeros_like(counts)
    out[:-1] = rows[:i].sum(0)
    return out


def sort_pairs(experts: torch.Tensor, n_experts: int):
    """The (token, expert) pairs of ``experts`` (T, K), stably sorted by
    expert: the sort order, the expert and token of each sorted pair,
    the pair count per expert (``n_experts``,) and each pair's position
    inside its expert's group."""
    t, k = experts.shape
    flat = experts.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    stok = order // k                      # pair i belongs to token i // k
    counts = torch.zeros(n_experts, dtype=torch.long, device=se.device)
    counts.scatter_add_(0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=se.device) - starts[se]
    return order, se, stok, counts, pos


def block_layout(counts: torch.Tensor, n_pairs: int, bt: int):
    """Every expert group padded to whole ``bt``-row blocks, laid out in
    expert order within the static bound ``round_up(n_pairs, bt) + E*bt``
    rows: (that bound, each group's first row (E,), each block's expert
    (NB,) int32 and its real rows (NB,) int32).  The trailing blocks hold
    no pair and map to expert E-1, as in JAX."""
    e = counts.shape[0]
    padded = (counts + bt - 1) // bt * bt
    ends = torch.cumsum(padded, 0)
    starts = ends - padded
    tp = round_up(n_pairs, bt) + e * bt
    block_first = torch.arange(tp // bt, device=counts.device) * bt
    block_expert = torch.clamp(
        (block_first[:, None] >= ends[None, :]).sum(1), max=e - 1)
    block_rows = torch.clamp(
        counts[block_expert] - (block_first - starts[block_expert]), 0, bt)
    return (tp, starts, block_expert.to(torch.int32),
            block_rows.to(torch.int32))


def _dispatch_xla(cfg: ModelConfig, w, e0: int, x2d: torch.Tensor,
                  gates: torch.Tensor, experts: torch.Tensor,
                  capacity_factor: float) -> torch.Tensor:
    """Capacity-bounded dispatch of the pairs routed to the experts ``w``
    (w_gate, w_up, w_down of experts ``e0`` on): the first C pairs of
    each expert go through a batched einsum, the rest are dropped.  C
    and each pair's place in its expert's queue count the whole batch
    (every rank's tokens).  Only kept pairs are written to the (E, C)
    tables: the dropped ones land in a spare column C that is cut off.
    JAX writes each dropped pair's pad entry onto its expert's slot 0
    instead, where the last write wins on the CPU, so when an expert
    overflows JAX loses the token of its slot 0 and the port keeps it
    (``tests/test_torch_train.py``).  The smoke configurations are
    dropless, so the two agree there."""
    t, d = x2d.shape
    e, k = w[0].shape[0], cfg.top_k
    c = int(max(1, math.ceil(t * batch_lines() * k * capacity_factor
                             / cfg.n_experts)))
    order, se, stok, counts, pos, _ = _local_pairs(experts, e0, e)
    pos = pos + _before(counts)[se]
    sg = gates.reshape(-1)[order]
    col = torch.where(pos < c, pos, c)
    # (E, C) token table; empty slots point at the zero pad row
    table = torch.full((e + 1, c + 1), t, dtype=torch.long,
                       device=x2d.device)
    table[se, col] = stok
    gtable = torch.zeros((e + 1, c + 1), dtype=torch.float32,
                         device=x2d.device)
    gtable = gtable.index_put((se, col), sg)
    table, gtable = table[:e, :c], gtable[:e, :c]

    x_pad = torch.cat([x2d, x2d.new_zeros((1, d))])
    # index_select, not x_pad[table]: its backward is an index_add_; that
    # of advanced indexing sorts the indices and walks each row's
    # duplicates serially (every empty slot names the pad row), 22 ms a
    # layer at granite's 4096 tokens on the H100, half of a train step
    xe = x_pad.index_select(0, table.reshape(-1)).reshape(e, c, d)
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", xe, w[0]))
    h = h * torch.einsum("ecd,edf->ecf", xe, w[1])
    ye = torch.einsum("ecf,efd->ecd", h, w[2])               # (E, C, D)

    y = torch.zeros((t + 1, d), dtype=torch.float32, device=x2d.device)
    y.index_add_(0, table.reshape(-1),
                 (ye * gtable[..., None]).reshape(-1, d).float())
    return y[:t].to(x2d.dtype)


def _dispatch_pallas(cfg: ModelConfig, w, e0: int, x2d: torch.Tensor,
                     gates: torch.Tensor, experts: torch.Tensor,
                     bt: int = 128) -> torch.Tensor:
    """Dropless dispatch of the pairs routed to the experts ``w`` (of
    experts ``e0`` on) through ``grouped_matmul``: each expert group
    fills whole blocks (:func:`block_layout`), and each block's count of
    real rows goes to the kernel beside its expert.  Each token sums its
    top-k expert outputs in a fixed order (its pairs' own order; other
    ranks' pairs add zero), where JAX scatter-adds them: a float32
    ``index_add_`` on the card adds with atomics in an order that
    changes from run to run, and the rounding would move full-width
    greedy streams between runs."""
    t, d = x2d.shape
    e, k = w[0].shape[0], cfg.top_k
    order, se, stok, counts, pos, local = _local_pairs(experts, e0, e)
    tp, starts, block_expert, block_rows = block_layout(counts[:e], t * k,
                                                        bt)
    # other ranks' pairs land in a spare row tp
    slot = torch.where(se < e, starts[torch.clamp(se, max=e - 1)] + pos, tp)
    xs = x2d.new_zeros((tp + 1, d))
    xs[slot] = x2d[stok]
    xs = xs[:tp]

    def gmm(a, wt):
        return grouped_matmul(a, wt, block_expert, bt=bt,
                              block_rows=block_rows)

    h = torch.nn.functional.silu(gmm(xs, w[0])) * gmm(xs, w[1])
    ys = gmm(h, w[2])                                    # (TP, D)
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot                  # the row of pair (token, k)
    g = torch.where(local, gates, 0.0)
    contrib = (ys[torch.clamp(pair_slot, max=tp - 1)].float()
               .reshape(t, k, d) * g[..., None])
    return contrib.sum(1).to(x2d.dtype)


def moe_aux_loss(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): ``n_experts`` times
    the dot product of the mean router probability and the share of the
    top-k assignments of each expert."""
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    logits = (x2d @ p.router.to(cfg.adtype)).float()
    probs = torch.softmax(logits, -1)
    _, experts = torch.topk(probs, cfg.top_k, dim=-1)
    me = probs.mean(0)
    ce = torch.zeros(cfg.n_experts, dtype=torch.float32, device=x.device)
    ce = ce.index_add(0, experts.reshape(-1),
                      torch.ones(experts.numel(), device=x.device))
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    return cfg.n_experts * torch.sum(me * ce)
