"""The split-KV decodes' arithmetic on the CPU.

``csrc/split_decode.cuh`` is the body of both decodes: the paged one
(``Table``: block j of a request is the pool page its table names) and
the contiguous one (``Contig``: block j is rows ``j*bk .. j*bk + bk - 1``
of its head in the cache).  It cuts each request's blocks into splits of
``pps`` blocks (``kernel.paged_splits``, from the request's width in
blocks and the card's SM count), gives each of a CTA's warps every
``PAGED_WARPS``-th block of its split, runs an online softmax per
16-token sub-block in each warp (in base 2), for each sub-group of at
most 8 query rows in turn while the block sits in the warp's ring,
merges the warps' ``(m, l, acc)`` once per CTA and, where a request has
more than one active split, the splits' f32 partials by log-sum-exp.
The CUDA kernel runs only on the card; this file mirrors that order of
operations in torch on the CPU, over the wrapper's own split rule, and
holds it to the JAX package's ``flash_decode_paged`` or ``flash_decode``
(their Pallas kernels in interpret mode) and to JAX's ``decode_ref`` on
the same cache.  float32 throughout, tolerance 1e-5: the three sum in
float32 in different orders.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_decode as jax_decode
from repro.kernels.flash_attention.ops import \
    flash_decode_paged as jax_decode_paged
from repro.kernels.flash_attention.ref import decode_ref as jax_decode_ref
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.flash_attention import kernel as fk
from test_torch_split_layout import sub_rows

ATOL = 1e-5
NEG = -1e30            # the kernel's masked score
LOG2E = 1.4426950408889634
SUB = 16               # tokens per softmax sub-block (kSub)
B, KVH, TOKENS = 4, 2, 192


def _mirror(q, block, nblk, page, cap, lengths, scale, sms):
    """The kernel's split, warp and sub-block order in float32 torch;
    ``block(b, h, j)`` is block j of request b, head h: (K, V) rows."""
    b, kvh, g, d = q.shape
    gs = sub_rows(g)
    pps, nsplit = fk.paged_splits(b, kvh, nblk, sms)
    warps = fk.PAGED_WARPS
    out = torch.zeros_like(q)
    active = []
    for bi in range(b):
        ln = max(0, min(int(lengths[bi]), cap))
        npages = cdiv(ln, page)
        nactive = max(1, cdiv(npages, pps))
        active.append((nactive, nsplit))
        for h in range(kvh):
            parts = []
            for sp in range(nactive):
                first = sp * pps
                mine = max(0, min(pps, npages - first))
                per_warp = []
                for w in range(warps):
                    m = torch.full((g,), NEG)
                    l = torch.zeros(g)
                    acc = torch.zeros(g, d)
                    for j in range(w, mine, warps):
                        kb, vb = block(bi, h, first + j)
                        visible = min(page, ln - (first + j) * page)
                        for rs in (slice(r, r + gs) for r in range(0, g, gs)):
                            for sb in range(0, visible, SUB):
                                rows = min(SUB, visible - sb)
                                k = kb[sb:sb + rows]
                                v = vb[sb:sb + rows]
                                s = (q[bi, h, rs] @ k.T) * (scale * LOG2E)
                                m_new = torch.maximum(m[rs], s.max(1).values)
                                p = torch.exp2(s - m_new[:, None])
                                alpha = torch.exp2(m[rs] - m_new)
                                l[rs] = l[rs] * alpha + p.sum(1)
                                acc[rs] = acc[rs] * alpha[:, None] + p @ v
                                m[rs] = m_new
                    per_warp.append((m, l, acc))
                wm = torch.stack([x[0] for x in per_warp])
                mx = wm.max(0).values
                wgt = torch.exp2(wm - mx)
                parts.append((mx,
                              sum(x[1] * wgt[i] for i, x in
                                  enumerate(per_warp)),
                              sum(x[2] * wgt[i][:, None] for i, x in
                                  enumerate(per_warp))))
            sm = torch.stack([x[0] for x in parts])
            mx = sm.max(0).values
            wgt = torch.exp2(sm - mx)
            lsum = sum(x[1] * wgt[i] for i, x in enumerate(parts))
            asum = sum(x[2] * wgt[i][:, None] for i, x in enumerate(parts))
            out[bi, h] = asum / torch.clamp(lsum, min=1e-30)[:, None]
    return out, active


@functools.lru_cache(maxsize=None)
def _case(g, d, page):
    rng = np.random.default_rng(100 * g + d + page)
    npb = TOKENS // page
    n_pages = 1 + B * npb
    q = rng.standard_normal((B, KVH, g, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, KVH, page, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, KVH, page, d)).astype(np.float32)
    table = (rng.permutation(n_pages - 1) + 1).astype(np.int32)
    table = table.reshape(B, npb)
    # len 1, a page multiple, a page multiple + 1, the whole table
    lengths = np.array([1, 2 * page, 2 * page + 1, TOKENS], np.int32)
    scale = d ** -0.5
    jax_out = np.asarray(jax_decode_paged(
        jnp.asarray(q.reshape(B, KVH * g, d)), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table), jnp.asarray(lengths), rif=2,
        method="pallas", interpret=True)).reshape(B, KVH, g, d)
    caches = [np.transpose(p[table], (0, 2, 1, 3, 4)).reshape(
        B, KVH, npb * page, d) for p in (kp, vp)]
    ref = np.asarray(jax_decode_ref(
        jnp.asarray(q.reshape(B, KVH * g, d)), jnp.asarray(caches[0]),
        jnp.asarray(caches[1]), jnp.asarray(lengths), scale=scale)
    ).reshape(B, KVH, g, d)
    return q, kp, vp, table, lengths, scale, jax_out, ref


@functools.lru_cache(maxsize=None)
def _contig_case(g, d, bk):
    """A contiguous (B, KVH, S, D) cache read in blocks of bk tokens."""
    rng = np.random.default_rng(1000 + 100 * g + d + bk)
    q = rng.standard_normal((B, KVH, g, d)).astype(np.float32)
    kc = rng.standard_normal((B, KVH, TOKENS, d)).astype(np.float32)
    vc = rng.standard_normal((B, KVH, TOKENS, d)).astype(np.float32)
    # len 1, one block, one block + 1, the whole cache
    lengths = np.array([1, bk, bk + 1, TOKENS], np.int32)
    scale = d ** -0.5
    args = (jnp.asarray(q.reshape(B, KVH * g, d)), jnp.asarray(kc),
            jnp.asarray(vc), jnp.asarray(lengths))
    jax_out = np.asarray(jax_decode(*args, bk=bk, rif=2, method="pallas",
                                    interpret=True)).reshape(B, KVH, g, d)
    ref = np.asarray(jax_decode_ref(*args, scale=scale)).reshape(
        B, KVH, g, d)
    return q, kc, vc, lengths, scale, jax_out, ref


@pytest.mark.parametrize("policy,g,d", [
    pytest.param("table", 3, 64, id="3-64"),
    pytest.param("table", 4, 128, id="4-128"),
    pytest.param("contig", 1, 96, id="contig-1-96"),      # MLA: minicpm3-4b
    pytest.param("contig", 1, 192, id="contig-1-192"),    # deepseek-v2-lite
    pytest.param("contig", 4, 128, id="contig-4-128"),    # qwen3-4b
    pytest.param("table", 48, 128, id="48-128"),          # granite-34b
    pytest.param("contig", 16, 64, id="contig-16-64")])   # two sub-groups
@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("sms", [1, 8, 132])
def test_split_merge_matches_jax(policy, g, d, page, sms):
    """``page`` is the block: a pool page (Table) or bk tokens (Contig)."""
    if policy == "table":
        q, kp, vp, table, lengths, scale, jax_out, ref = _case(g, d, page)
        kp, vp, table = (torch.from_numpy(a) for a in (kp, vp, table))

        def block(bi, h, j):
            pg = int(table[bi, j])
            return kp[pg, h], vp[pg, h]
        nblk = table.shape[1]
    else:
        q, kc, vc, lengths, scale, jax_out, ref = _contig_case(g, d, page)
        kc, vc = torch.from_numpy(kc), torch.from_numpy(vc)

        def block(bi, h, j):
            rows = slice(j * page, (j + 1) * page)
            return kc[bi, h, rows], vc[bi, h, rows]
        nblk = cdiv(TOKENS, page)
    got, active = _mirror(torch.from_numpy(q), block, nblk, page, TOKENS,
                          torch.from_numpy(lengths), scale, sms)
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    nactive, nsplit = zip(*active)
    if sms > 1:
        # len 1 leaves every split but the first wholly past len, and the
        # full length merges several splits
        assert nactive[0] == 1 and nsplit[0] > 1
        assert nactive[-1] > 1


@pytest.mark.parametrize("batch,npb,pps,nsplit", [
    (8, 128, 15, 9),       # the main path: 8 slots, 2048 tokens in pages of 16
    (1, 128, 4, 32),       # one request decoding: one page a warp
    (8, 64, 8, 8),         # chip_smoke's serve: s_max 1024
    (8, 2, 2, 1),          # a table narrower than the warps
])
def test_split_rule_fills_the_card(batch, npb, pps, nsplit):
    """At least two CTAs per SM on an H100's 132 SMs for 8 slots x 8 KV
    heads, at least one page a warp, and every page in some split."""
    got = fk.paged_splits(batch, 8, npb, 132)
    assert got == (pps, nsplit)
    assert pps * nsplit >= npb > pps * (nsplit - 1)
    if batch == 8 and npb >= 16:
        assert batch * 8 * nsplit >= 2 * 132
