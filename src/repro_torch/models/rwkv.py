"""RWKV6 "Finch" block: the counterpart of ``repro.models.rwkv``, a
time-mix with data-dependent decay and a channel-mix.

Attention-free: the WKV state is a per-head (hd x hd) matrix updated
once a token, so decoding carries a constant-size state.  The
recurrence is a sequential loop over the tokens in float32 in the order
of JAX's ``lax.scan`` step, so a chunked cache fill and stepwise decode
do the same arithmetic; the products that do not depend on the state
(``k v^T`` and ``u k v^T``) are formed for a block of tokens at once,
which leaves every value unchanged.

In a sharded step (``parallel/sharding.py::step_shards``) the time mix
runs on the heads a rank's rows of ``wo`` read: ``wr``, ``wk``, ``wv``,
``wg`` and ``w_lora_b`` are column-parallel (a head the cut splits is
gathered whole, and the recurrence runs once on each rank that holds a
part of it), ``u_bonus`` is cut on its heads where ``model`` divides
them, the replicated leaves (``w0``, the group norm's gain ``ln_g``, the
mixes, ``w_lora_a``) are sliced to the rank's heads or computed whole,
and ``wo`` is row-parallel, summed over ``model``.  The recurrent states
stay whole over ``model``: every rank writes every head's WKV state.
The channel mix's ``wk`` and ``wr`` are column-parallel and its ``wv``
``(d_ff, D)`` is cut on its *output* D, as JAX's rules cut it (its name
is a column-parallel one), so the rank's hidden columns cannot go
straight into it: the step gathers whichever is smaller, the hidden
(B, S, d_ff) or ``wv`` whole (:func:`rwkv_channel_apply`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.attention import head_cut
from repro_torch.models.common import (ModelConfig, dense_param, drawn,
                                       vector_param)
from repro_torch.parallel.sharding import (model_cols, model_cut,
                                           model_block, model_part,
                                           tp_enter, tp_gather, tp_out,
                                           tp_place, use)

State = Dict[str, torch.Tensor]
_BLOCK = 64          # tokens whose k v^T are formed at once


class RWKVTimeMix(nn.Module):
    """``rwkv_time_init``'s leaves: the token-shift mixes ``mix_r``,
    ``mix_k``, ``mix_v``, ``mix_w``, ``mix_g`` (d,), the projections
    ``wr``, ``wk``, ``wv``, ``wg``, ``wo`` (d, d), the base decay ``w0``
    (d,) and its LoRA ``w_lora_a`` (d, lora), ``w_lora_b`` (lora, d),
    the bonus ``u_bonus`` (H, hd) and the group-norm gain ``ln_g`` (d,).
    Matrices are stored in ``dtype`` (default ``cfg.dtype``), the other
    leaves in float32."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.rwkv_head_dim, dtype or cfg.adtype
        h, lora = d // hd, max(32, d // 32)
        for name in ("r", "k", "v", "w", "g"):
            setattr(self, "mix_" + name,
                    vector_param(drawn((d,), device, generator, False)))
        for name in ("wr", "wk", "wv", "wg"):
            setattr(self, name, dense_param((d, d), dt, device, generator))
        self.w0 = vector_param(torch.full((d,), -6.0, device=device))
        self.w_lora_a = dense_param((d, lora), dt, device, generator)
        self.w_lora_b = dense_param((lora, d), dt, device, generator)
        self.u_bonus = vector_param(
            drawn((h, hd), device, generator, True) * 0.1)
        self.wo = dense_param((d, d), dt, device, generator)
        self.ln_g = vector_param(torch.ones((d,), device=device))


class RWKVChannelMix(nn.Module):
    """``rwkv_channel_init``'s leaves: ``mix_k``, ``mix_r`` (d,), ``wk``
    (d, d_ff), ``wv`` (d_ff, d) and ``wr`` (d, d)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d, dt = cfg.d_model, dtype or cfg.adtype
        self.mix_k = vector_param(drawn((d,), device, generator, False))
        self.mix_r = vector_param(drawn((d,), device, generator, False))
        self.wk = dense_param((d, cfg.d_ff), dt, device, generator)
        self.wv = dense_param((cfg.d_ff, d), dt, device, generator)
        self.wr = dense_param((d, d), dt, device, generator)


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x (B, S, D) shifted right by one token; ``prev`` (B, D) is the
    last token of the previous chunk (decode), zeros without it."""
    if prev is None:
        pad = torch.zeros_like(x[:, :1])
    else:
        pad = prev[:, None, :].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, wkv: torch.Tensor,
         valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence over S tokens, float32: r, k, v, w (B, S, H,
    hd); u (H, hd); wkv (B, H, hd, hd) the state before the first token.
    Token t reads ``r_t (wkv + u k_t v_t^T)`` and then, where ``valid``
    (B, S) holds (every token without it), advances ``wkv`` to
    ``w_t wkv + k_t v_t^T``.  Returns the outputs (B, S, H, hd) and the
    final state."""
    s = r.shape[1]
    outs = []
    for t0 in range(0, s, _BLOCK):
        t1 = min(s, t0 + _BLOCK)
        kv = k[:, t0:t1, :, :, None] * v[:, t0:t1, :, None, :]
        ukv = u[None, None, :, :, None] * kv
        for t in range(t1 - t0):
            rt = r[:, t0 + t, :, None, :]                       # (B,H,1,hd)
            outs.append(torch.matmul(rt, wkv + ukv[:, t])[:, :, 0])
            new = w[:, t0 + t, :, :, None] * wkv + kv[:, t]
            wkv = new if valid is None else torch.where(
                valid[:, t0 + t, None, None, None], new, wkv)
    return torch.stack(outs, dim=1), wkv


def rwkv_time_apply(cfg: ModelConfig, p: RWKVTimeMix, x: torch.Tensor,
                    state: Optional[State] = None,
                    valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[State]]:
    """WKV6 time mix.  state = {"shift": (B, D), "wkv": (B, H, hd, hd)}.

    ``valid`` (B, S) gates the recurrence for chunked cache fill: rows
    advance their WKV and shift state only through their valid tokens,
    and a row with none keeps its state bit for bit (the serve loop's
    masked decode relies on that).  Returns new state tensors; the
    caller stores them."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    dt = cfg.adtype
    hs = head_cut(p.wo, h, hd)        # this rank's heads in a sharded step
    hn, lo, hi = hs.h1 - hs.h0, hs.h0 * hd, hs.h1 * hd

    xs = _token_shift(x, None if state is None else state["shift"])

    def mixed(name):
        m = getattr(p, "mix_" + name).to(dt)
        return x * m + xs * (1 - m)

    def proj(w, inp, a=lo, z=hi):
        """Columns [a, z) of ``inp @ w``, the whole ``inp`` entering the
        rank's heads through f."""
        if hs.split:
            inp = tp_enter(inp)
        return model_cols(w, inp @ use(w).to(dt), a, z, d)

    r = proj(p.wr, mixed("r")).reshape(b, s, hn, hd)
    k = proj(p.wk, mixed("k")).reshape(b, s, hn, hd)
    v = proj(p.wv, mixed("v")).reshape(b, s, hn, hd)
    g = F.silu(proj(p.wg, mixed("g"), hs.c0, hs.c1))

    # data-dependent decay (the Finch contribution): w = exp(-exp(w0 + lora))
    w0 = model_part(p.w0, lo, hi) if hs.split else p.w0
    wln = (w0.float()
           + proj(p.w_lora_b, mixed("w") @ p.w_lora_a.to(dt)).float())
    w = torch.exp(-torch.exp(wln)).reshape(b, s, hn, hd)       # in (0, 1)

    u = model_part(p.u_bonus, hs.h0, hs.h1) if hs.split else p.u_bonus
    wkv0 = (torch.zeros((b, hn, hd, hd), dtype=torch.float32,
                        device=x.device) if state is None
            else state["wkv"][:, hs.h0:hs.h1].float())
    y, wkv_fin = _wkv(r.float(), k.float(), v.float(), w, u.float(), wkv0,
                      valid)

    # per-head groupnorm
    mu = y.mean(-1, keepdim=True)
    centered = y - mu
    var = (centered * centered).mean(-1, keepdim=True)
    y = (centered * torch.rsqrt(var + 64e-5)).reshape(b, s, hn * hd)
    y = y * (model_part(p.ln_g, lo, hi) if hs.split else p.ln_g).float()
    if (hs.c0, hs.c1) != (lo, hi):     # the rank's columns of its heads
        y = y[..., hs.c0 - lo:hs.c1 - lo]

    y = tp_out((y.to(dt) * g) @ use(p.wo).to(dt), hs.split)
    new_state = None
    if state is not None:
        new_state = {"shift": _last_valid(x, state["shift"], valid),
                     "wkv": _whole_heads(hs, h, hd, wkv_fin).to(
                         state["wkv"].dtype)}
    return y, new_state


def _whole_heads(hs, h: int, hd: int, part: torch.Tensor) -> torch.Tensor:
    """Every head's WKV state (B, H, hd, hd) from this rank's heads'
    ``part``: each head's from the rank that holds its first column
    (:func:`tp_place`; a head the cut splits is computed on two ranks)."""
    if not hs.split:
        return part
    o0, o1 = -(-hs.c0 // hd), -(-hs.c1 // hd)    # heads that start here
    return tp_place(part[:, o0 - hs.h0:o1 - hs.h0], o0, h, 1)


def _last_valid(x: torch.Tensor, prev: torch.Tensor,
                valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Shift-state update: x (B, S, D) -> the last *valid* token of each
    row, ``prev`` (B, D) for rows with no valid token."""
    if valid is None:
        return x[:, -1, :]
    n_valid = valid.sum(-1)
    idx = torch.clamp(n_valid - 1, min=0)
    last = x[torch.arange(x.shape[0], device=x.device), idx]
    return torch.where((n_valid > 0)[:, None], last, prev.to(x.dtype))


def rwkv_channel_apply(cfg: ModelConfig, p: RWKVChannelMix, x: torch.Tensor,
                       state: Optional[torch.Tensor] = None,
                       valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The channel mix; ``state`` is the shift state (B, D) or None.

    In a sharded step ``k`` and ``r`` are this rank's columns (of d_ff
    and of D).  Where the hidden ``k`` (B, S, d_ff) is no larger than
    ``wv`` (d_ff, D), it is gathered and meets the rank's output columns
    of ``wv``, and the gated columns are assembled whole; else ``wv`` is
    gathered whole, the rank's rows of it meet its hidden columns, the
    partial sums are added over ``model`` and the gate is assembled
    whole.  On a residual stream cut along its tokens (``act_sp``) the
    assembled columns and the partial sums are reduce-scattered to the
    rank's tokens and the whole gate narrowed to them (``tp_out``)."""
    dt = cfg.adtype
    xs = _token_shift(x, state)
    mk = p.mix_k.to(dt)
    mr = p.mix_r.to(dt)
    xk = x * mk + xs * (1 - mk)
    xr = x * mr + xs * (1 - mr)
    new = _last_valid(x, state, valid) if state is not None else None
    cut = model_cut(p.wv)
    if cut is None:
        k = F.relu(xk @ use(p.wk).to(dt)) ** 2
        r = torch.sigmoid(xr @ use(p.wr).to(dt))
        return tp_out(r * (k @ use(p.wv).to(dt)), False), new
    d = x.shape[-1]
    _, n, j = cut
    c0 = j * d // n
    k = F.relu(tp_enter(xk) @ use(p.wk).to(dt)) ** 2      # its d_ff columns
    r = torch.sigmoid(tp_enter(xr) @ use(p.wr).to(dt))    # its D columns
    wv = use(p.wv).to(dt)                                 # (d_ff, D / n)
    if k.numel() <= wv.numel():
        return tp_out(model_block(r * (tp_gather(k) @ wv), c0, d),
                      True), new
    f = k.shape[-1]
    kv = tp_out(k @ tp_gather(wv, 1)[j * f:(j + 1) * f], True)
    return tp_out(tp_place(r, c0, d), False) * kv, new


def rwkv_state_init(cfg: ModelConfig, count: int, batch: int,
                    device: torch.device) -> Dict[str, Any]:
    """Zero states of ``count`` stacked layers: the two shift states in
    ``cfg.dtype`` and the WKV state in float32."""
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    shift = (count, batch, d)
    return {
        "time_shift": torch.zeros(shift, dtype=cfg.adtype, device=device),
        "wkv": torch.zeros((count, batch, d // hd, hd, hd),
                           dtype=torch.float32, device=device),
        "chan_shift": torch.zeros(shift, dtype=cfg.adtype, device=device),
    }
