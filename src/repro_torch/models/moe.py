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
nothing).  Nothing here syncs with the host: the padded length is the
static bound ``round_up(T*K, bt) + E*bt`` and counts come from
``scatter_add_``, not ``bincount``.  ``moe_aux_loss`` (training) waits
for a later slice.
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


class MoE(nn.Module):
    """``router`` (d_model, n_experts); ``w_gate``/``w_up`` (E, d_model,
    F) and ``w_down`` (E, F, d_model) with E the padded expert count; the
    optional ``shared`` MLP.  All stored in ``cfg.dtype``, as JAX casts
    them at every use."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        e, d = cfg.n_experts_padded, cfg.d_model
        f, dt = cfg.moe_d_ff or cfg.d_ff, cfg.adtype
        self.router = dense_param((d, cfg.n_experts), dt, device, generator)
        self.w_gate = dense_param((e, d, f), dt, device, generator)
        self.w_up = dense_param((e, d, f), dt, device, generator)
        self.w_down = dense_param((e, f, d), dt, device, generator)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, device, generator,
                              d_ff=f * cfg.n_shared_experts)


def _route(cfg: ModelConfig, p: MoE, x2d: torch.Tensor):
    """x2d (T, D) -> gates (T, K) float32, experts (T, K) int32."""
    logits = (x2d @ p.router).float()
    gates, experts = torch.topk(torch.softmax(logits, dim=-1), cfg.top_k,
                                dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts.to(torch.int32)


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor, *,
              capacity_factor: float = 0.0) -> torch.Tensor:
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, experts = _route(cfg, p, x2d)
    if cfg.kernel_mode == "kernel":
        y2d = _dispatch_pallas(cfg, p, x2d, gates, experts)
    else:
        y2d = _dispatch_xla(cfg, p, x2d, gates, experts,
                            capacity_factor or cfg.capacity_factor)
    if cfg.n_shared_experts:
        y2d = y2d + mlp_apply(cfg, p.shared, x2d)
    return y2d.reshape(b, s, d)


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


def _dispatch_xla(cfg: ModelConfig, p: MoE, x2d: torch.Tensor,
                  gates: torch.Tensor, experts: torch.Tensor,
                  capacity_factor: float) -> torch.Tensor:
    """Capacity-bounded dispatch: the first C pairs of each expert go
    through a batched einsum, the rest are dropped.  (JAX also scatters
    each dropped pair's pad entry onto its expert's slot 0, in an order
    XLA leaves open; only kept pairs are written here.  No configuration
    the port compares with JAX drops a pair.)"""
    t, d = x2d.shape
    e, k = cfg.n_experts_padded, cfg.top_k
    c = int(max(1, math.ceil(t * k * capacity_factor / cfg.n_experts)))
    order, se, stok, _, pos = sort_pairs(experts, e)
    sg = gates.reshape(-1)[order]
    keep = pos < c
    se_k, pos_k = se[keep], pos[keep]
    # (E, C) token table; dropped and empty slots point at the zero pad row
    table = torch.full((e, c), t, dtype=torch.long, device=x2d.device)
    table[se_k, pos_k] = stok[keep]
    gtable = torch.zeros((e, c), dtype=torch.float32, device=x2d.device)
    gtable[se_k, pos_k] = sg[keep]

    x_pad = torch.cat([x2d, x2d.new_zeros((1, d))])
    xe = x_pad[table]                                   # (E, C, D)
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", xe, p.w_gate))
    h = h * torch.einsum("ecd,edf->ecf", xe, p.w_up)
    ye = torch.einsum("ecf,efd->ecd", h, p.w_down)      # (E, C, D)

    y = torch.zeros((t + 1, d), dtype=torch.float32, device=x2d.device)
    y.index_add_(0, table.reshape(-1),
                 (ye * gtable[..., None]).reshape(-1, d).float())
    return y[:t].to(x2d.dtype)


def _dispatch_pallas(cfg: ModelConfig, p: MoE, x2d: torch.Tensor,
                     gates: torch.Tensor, experts: torch.Tensor,
                     bt: int = 128) -> torch.Tensor:
    """Dropless dispatch through ``grouped_matmul``: each expert group
    fills whole blocks (:func:`block_layout`), and each block's count of
    real rows goes to the kernel beside its expert.  Each token sums its
    top-k expert outputs in a fixed order (its pairs' own order), where
    JAX scatter-adds them: a float32 ``index_add_`` on the card adds
    with atomics in an order that changes from run to run, and the
    rounding would move full-width greedy streams between runs."""
    t, d = x2d.shape
    k = cfg.top_k
    order, se, stok, counts, pos = sort_pairs(experts, cfg.n_experts_padded)
    tp, starts, block_expert, block_rows = block_layout(counts, t * k, bt)
    slot = starts[se] + pos
    xs = x2d.new_zeros((tp, d))
    xs[slot] = x2d[stok]

    def gmm(a, w):
        return grouped_matmul(a, w, block_expert, bt=bt,
                              block_rows=block_rows)

    h = torch.nn.functional.silu(gmm(xs, p.w_gate)) * gmm(xs, p.w_up)
    ys = gmm(h, p.w_down)                                # (TP, D)
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot                  # the row of pair (token, k)
    contrib = ys[pair_slot].float().reshape(t, k, d) * gates[..., None]
    return contrib.sum(1).to(x2d.dtype)
