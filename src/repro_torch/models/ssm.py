"""Selective state-space (Mamba-style) mixer used by the Hymba hybrid:
the counterpart of ``repro.models.ssm``.

The cache-free forward scans the sequence with the odd/even recursion
of ``jax.lax.associative_scan`` (2 log2 S vectorised steps, combining
in the reference's order); decoding carries (conv window, SSM state)
and a chunked cache fill runs the decode recurrence token by token.

In a sharded step (``parallel/sharding.py::step_shards``) a rank runs
the channels ``[d0, d1)`` of DI its rows of ``w_out`` hold, as JAX's
rules cut ``conv_w``, ``conv_b``, ``dt_bias``, ``d_skip``, ``a_log`` and
``w_dt``.  ``w_in`` (D, 2 DI) holds x and the gate z side by side, so
its column cut gives ranks x or z, not their own channels of both: its
output is gathered over ``model`` and each rank takes its channels of x
and of z.  ``w_bcdt`` (DI, 2N + dt_rank) is not cut, so the rank's
channels give a partial sum, added over ``model`` (then entered through
f, since every rank's channels read it).  ``w_out`` is row-parallel,
summed over ``model``.  The states stay whole over ``model``: the
gathered x writes every channel's conv window, and the channels' SSM
states are gathered.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (ModelConfig, dense_param, drawn,
                                       vector_param)
from repro_torch.parallel.sharding import (model_cut, tp_enter, tp_gather,
                                           tp_leave, tp_out, use)

State = Dict[str, torch.Tensor]


class SSM(nn.Module):
    """``ssm_init``'s leaves: ``w_in`` (d, 2 di) for x and the gate z,
    the depthwise causal conv ``conv_w`` (K, di) and ``conv_b`` (di,),
    ``w_bcdt`` (di, 2N + dt_rank), ``w_dt`` (dt_rank, di), ``dt_bias``
    (di,), ``a_log`` (di, N), ``d_skip`` (di,) and ``w_out`` (di, d).
    Matrices are stored in ``dtype`` (default ``cfg.dtype``), the other
    leaves in float32."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d, dt = cfg.d_model, dtype or cfg.adtype
        di, n = cfg.ssm_expand * d, cfg.ssm_state
        self.w_in = dense_param((d, 2 * di), dt, device, generator)
        self.conv_w = vector_param(
            drawn((cfg.ssm_conv, di), device, generator, True) * 0.1)
        self.conv_b = vector_param(torch.zeros((di,), device=device))
        self.w_bcdt = dense_param((di, 2 * n + cfg.dt_rank), dt, device,
                                  generator)
        self.w_dt = dense_param((cfg.dt_rank, di), dt, device, generator)
        # softplus(-4.6) ~ 0.01
        self.dt_bias = vector_param(torch.full((di,), -4.6, device=device))
        self.a_log = vector_param(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=device)).expand(di, n))
        self.d_skip = vector_param(torch.ones((di,), device=device))
        self.w_out = dense_param((di, d), dt, device, generator)


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   init_window: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """x (B, S, DI); w (K, DI) depthwise causal conv; ``init_window``
    (B, K-1, DI) the inputs before the first token (zeros without it)."""
    k, s = w.shape[0], x.shape[1]
    if init_window is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = init_window.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                     # (B, S+K-1, DI)
    out = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _combine(al, bl, ar, br):
    """The scan's operator: (al, bl) then (ar, br)."""
    return al * ar, br + ar * bl


def associative_scan(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan over dim 1 of ``h_t = a_t h_{t-1} + b_t`` pairs,
    by the recursion ``jax.lax.associative_scan`` uses: combine adjacent
    pairs, scan the half-length sequence, then fill in the even
    positions from it.  Returns the scanned (a, b)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    del ra, rb
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    out = []
    for first, even, odd in ((a, ea, oa), (b, eb, ob)):
        full = torch.empty_like(first)
        full[:, 0] = first[:, 0]
        full[:, 2::2] = even
        full[:, 1::2] = odd
        out.append(full)
    return out[0], out[1]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as JAX writes it."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def ssm_apply(cfg: ModelConfig, p: SSM, x: torch.Tensor,
              state: Optional[State] = None,
              valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[State]]:
    """x (B, S, D) -> (B, S, D).  ``state`` (decode): {"conv": (B, K-1,
    DI), "ssm": (B, DI, N)}.

    Without a state the sequence is scanned (:func:`associative_scan`).
    With a state and S == 1 and no ``valid`` it is one decode step.
    Otherwise it is the chunked cache fill: the decode recurrence runs
    over the chunk token by token, and a row advances only through its
    ``valid`` (B, S) tokens (every token without it), so a row with none
    keeps its state bit for bit.  Returns new state tensors; the caller
    stores them."""
    b, s, d = x.shape
    di, n = cfg.ssm_expand * d, cfg.ssm_state
    dt = cfg.adtype
    cut = model_cut(p.w_out)
    split = cut is not None
    d0, d1 = (0, di) if not split else (cut[2] * di // cut[1],
                                        (cut[2] + 1) * di // cut[1])

    xz = (tp_enter(x) if split else x) @ use(p.w_in).to(dt)  # (B,S,2DI)
    if split:        # the x | z re-cut: gathered, each rank's channels
        xz = tp_gather(xz)
    xs_all = xz[..., :di]
    xs, z = xs_all[..., d0:d1], xz[..., di + d0:di + d1]

    conv_in = None if state is None else state["conv"][..., d0:d1]
    xs_conv = F.silu(_conv1d_causal(xs, use(p.conv_w).to(dt),
                                    use(p.conv_b).to(dt), conv_in))

    w_bcdt = p.w_bcdt if not split else tp_enter(p.w_bcdt)[d0:d1]
    bcdt = xs_conv @ w_bcdt.to(dt)                           # (B,S,2N+dtr)
    if split:        # a partial sum over the rank's channels
        bcdt = tp_enter(tp_leave(bcdt))
    bmat = bcdt[..., :n].float()                             # (B,S,N)
    cmat = bcdt[..., n:2 * n].float()
    dt_in = bcdt[..., 2 * n:]
    delta = _softplus(dt_in @ use(p.w_dt).to(dt)
                      + use(p.dt_bias).to(dt)).float()

    a = -torch.exp(use(p.a_log).float())                     # (DI', N)
    # discretize: da (B,S,DI',N) decay, dbu the input
    da = torch.exp(delta[..., None] * a[None, None])
    dbu = (delta * xs_conv.float())[..., None] * bmat[:, :, None, :]
    del bmat, delta

    def whole(h_c):          # every channel's SSM state
        return tp_gather(h_c, 1) if split else h_c

    if state is None:
        _, h = associative_scan(da, dbu)
        new_state = None
    elif s == 1 and valid is None:
        h = (da[:, 0] * state["ssm"][:, d0:d1].float() + dbu[:, 0])[:, None]
        conv_win = torch.cat([state["conv"], xs_all], dim=1)[:, 1:]
        new_state = {"conv": conv_win,
                     "ssm": whole(h[:, 0]).to(state["ssm"].dtype)}
    else:
        if valid is None:
            valid = torch.ones((b, s), dtype=torch.bool, device=x.device)
        h_c = state["ssm"][:, d0:d1].float()
        hs = []
        for t in range(s):
            h_c = torch.where(valid[:, t, None, None],
                              da[:, t] * h_c + dbu[:, t], h_c)
            hs.append(h_c)
        h = torch.stack(hs, dim=1)                           # (B,S,DI',N)
        # conv window: the K-1 inputs ending at each row's last valid token
        hist = torch.cat([state["conv"].to(xs_all.dtype), xs_all], dim=1)
        idx = (valid.sum(-1)[:, None]
               + torch.arange(cfg.ssm_conv - 1, device=x.device)[None, :])
        conv_win = torch.gather(hist, 1, idx[..., None].expand(-1, -1, di))
        new_state = {"conv": conv_win.to(state["conv"].dtype),
                     "ssm": whole(h_c).to(state["ssm"].dtype)}
    del da, dbu

    y = torch.einsum("bsdn,bsn->bsd", h, cmat)               # (B,S,DI')
    del h
    y = y + xs_conv.float() * use(p.d_skip).float()
    y = y.to(dt) * F.silu(z)
    y = y @ use(p.w_out).to(dt)
    return tp_out(y, split), new_state


def ssm_init_state(cfg: ModelConfig, count: int, batch: int,
                   device: torch.device) -> Dict[str, Any]:
    """Zero states of ``count`` stacked layers: the conv window in
    ``cfg.dtype`` and the SSM state in float32."""
    di = cfg.ssm_expand * cfg.d_model
    return {
        "conv": torch.zeros((count, batch, cfg.ssm_conv - 1, di),
                            dtype=cfg.adtype, device=device),
        "ssm": torch.zeros((count, batch, di, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }
