"""The bf16 prefill kernel's arithmetic on the CPU.

``csrc/flash_prefill.cu`` runs only on the card.  This file mirrors its
order of work in torch: a CTA takes 128 query rows (two warpgroups of
64) and visits only the key blocks of ``bk`` keys that hold a visible
column for one of its rows; each warpgroup computes S = Q K^T in float32
from bf16 operands, masks only on blocks that cross Sk, the diagonal or
the window's edge (a masked score is -inf), runs the online softmax in
base 2 with scale x log2(e) folded in, and adds P V with P as a bf16 head
plus a bf16 remainder, accumulating in float32; the output is
acc / max(l, 1e-30) rounded to bf16.  The mirror runs at every key block
the CUDA source instantiates for head dims 64, 96, 128 and 192, and is
held to the JAX package's ``flash`` (its Pallas kernel in interpret
mode) on the same bf16-rounded inputs at ``chip_smoke.py``'s limit: one
bf16 ulp relative plus 1e-3.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro_torch.kernels.common import cdiv

BQ, WG_ROWS = 128, 64           # rows per CTA and per consumer warpgroup
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3
LOG2E = 1.4426950408889634
# keys per stage flash_prefill.cu instantiates at each bf16 head dim
BLOCK_KEYS = {64: (128, 64), 96: (128, 64), 128: (128, 64), 192: (64, 96)}
# (causal, window, H, KVH, S)
CASES = {
    "causal_ragged": (True, None, 2, 1, 300),
    "window_gqa": (True, 100, 4, 2, 260),
    "bidirectional": (False, None, 2, 2, 140),
}


def _key_blocks(q0, sq, sk, bk, causal, window):
    """The blocks [lo, lo + n) holding a visible column for a row of the
    CTA's q block (``key_blocks`` in the source)."""
    q_last = min(q0 + BQ, sq) - 1
    hi = min(sk, q_last + 1) if causal else sk
    first = max(0, q0 - window + 1) if window else 0
    lo = first // bk
    return lo, (cdiv(hi, bk) - lo if hi > first else 0)


def _visible(rows, cols, sk, causal, window):
    ok = cols[None, :] < sk
    if causal:
        ok = ok & (cols[None, :] <= rows[:, None])
    if window:
        ok = ok & (cols[None, :] >= rows[:, None] - window + 1)
    return ok


def _rows(x, start, n):
    """Rows start .. start + n - 1 of x, zeros past its end (TMA's fill)."""
    out = torch.zeros((n, x.shape[-1]))
    part = x[start:start + n]
    out[:part.shape[0]] = part
    return out


def _mirror(q, k, v, causal, window, scale, bk):
    b_, h_, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    scale2 = scale * LOG2E
    out = torch.zeros((b_, h_, sq, d), dtype=torch.bfloat16)
    for b in range(b_):
        for h in range(h_):
            kv = h // (h_ // kvh)
            for q0 in range(0, sq, BQ):
                lo, n = _key_blocks(q0, sq, sk, bk, causal, window)
                for r0 in (q0, q0 + WG_ROWS):
                    rows = torch.arange(r0, r0 + WG_ROWS)
                    qw = _rows(q[b, h], r0, WG_ROWS)
                    m = torch.full((WG_ROWS,), -1e30)
                    l = torch.zeros(WG_ROWS)
                    acc = torch.zeros((WG_ROWS, d))
                    for i in range(n):
                        k0 = (lo + i) * bk
                        kb = _rows(k[b, kv], k0, bk)
                        vb = _rows(v[b, kv], k0, bk)
                        s = qw @ kb.T
                        edge = (k0 + bk > sk
                                or (causal and k0 + bk - 1 > r0)
                                or (bool(window) and
                                    k0 < r0 + WG_ROWS - 1 - window + 1))
                        if edge:
                            cols = torch.arange(k0, k0 + bk)
                            s = torch.where(
                                _visible(rows, cols, sk, causal, window), s,
                                -torch.inf)
                        mn = torch.maximum(m, s.max(1).values * scale2)
                        alpha = torch.exp2(m - mn)
                        m = mn
                        p = torch.exp2(s * scale2 - mn[:, None])
                        l = l * alpha + p.sum(1)
                        head = p.to(torch.bfloat16).float()
                        rest = (p - head).to(torch.bfloat16).float()
                        acc = acc * alpha[:, None] + head @ vb + rest @ vb
                    o = (acc / torch.clamp(l, min=1e-30)[:, None]).to(
                        torch.bfloat16)
                    keep = min(WG_ROWS, max(0, sq - r0))
                    out[b, h, r0:r0 + keep] = o[:keep]
    return out


@functools.lru_cache(maxsize=None)
def _case(d, case):
    causal, window, h, kvh, s = CASES[case]
    rng = np.random.default_rng(7 * d + s)

    def bf16(shape):      # bf16-rounded values, held in float32
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()
    q, k, v = bf16((1, h, s, d)), bf16((1, kvh, s, d)), bf16((1, kvh, s, d))
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, bq=64, bk=64, method="pallas", interpret=True))
    return q, k, v, want


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d,bk", [(d, bk) for d in sorted(BLOCK_KEYS)
                                  for bk in BLOCK_KEYS[d]])
def test_prefill_order_matches_jax(d, bk, case):
    causal, window = CASES[case][:2]
    q, k, v, want = _case(d, case)
    got = _mirror(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                  window, d ** -0.5, bk).float().numpy()
    assert np.isfinite(got).all()
    limit = BF16_ATOL + BF16_RTOL * np.abs(want)
    err = np.abs(got - want)
    assert (err <= limit).all(), float(err.max())
