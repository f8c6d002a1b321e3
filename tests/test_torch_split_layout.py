"""The split-KV decodes' shared memory and split plan, on the CPU.

``csrc/split_decode.cuh`` sizes one CTA's shared memory (``Layout``) and
a split's f32 partial (``partial_floats``) by the query rows G of a KV
head, taken in sub-groups of at most 8 rows above 8.  ``layout`` and
``partial_floats`` below mirror those formulas; ``tests/test_torch_gpu.py``
holds the mirror to the compiled library's ``split_decode_smem`` and
``split_decode_partial`` on the card, and the tests here hold it to the
layout before sub-groups at G <= 8 and check what G 48 (granite-34b's
decode: 48 query heads over one KV head) asks of an H100.  This file
imports neither JAX nor the JAX package.
"""

import pytest

from repro_torch.kernels.common import cdiv
from repro_torch.kernels.flash_attention import kernel as fk

WARPS, SUB, MAX_SUB = 4, 16, 8       # kWarps, kSub, kMaxSub
OPTIN = 232_448                      # an H100's shared-memory opt-in
SMS = 132


def sub_groups(g):
    return cdiv(g, MAX_SUB)


def sub_rows(g):
    return cdiv(g, sub_groups(g))


def padded_rows(g):
    return sub_groups(g) * sub_rows(g)


def _r16(x):
    return cdiv(x, 16) * 16


def merge_head(gp):
    return (3 * WARPS * gp + 2 * gp + 3) // 4 * 4


def partial_floats(g, d):
    gp = padded_rows(g)
    return gp * d + (2 * gp + 3) // 4 * 4


def layout(g, d, page, depth, pps, nsplit, esize):
    """``split::Layout``: byte offsets of the merge arrays and of each
    region, and the total."""
    gp = padded_rows(g)
    ring = WARPS * depth * 2 * page * d * esize
    warp_merge = (merge_head(gp) + WARPS * gp * d) * 4
    split_merge = nsplit * 2 * gp * 4
    merge = _r16(ring) if sub_groups(g) > 1 else 0
    region = _r16(max(merge + warp_merge, ring, split_merge))
    q = region + _r16(WARPS * depth * 8)
    p = q + _r16(gp * d * 4)
    tbl = p + _r16(WARPS * sub_rows(g) * SUB * 4)
    flag = tbl + _r16(pps * 4)
    return {"merge": merge, "region": region, "q": q, "p": p, "tbl": tbl,
            "flag": flag, "total": flag + 16}


def _layout_before_sub_groups(g, d, page, depth, pps, nsplit, esize):
    """The layout as it was when G stopped at 8."""
    ring = WARPS * depth * 2 * page * d * esize
    warp_merge = ((3 * WARPS * g + 2 * g + 3) // 4 * 4 + WARPS * g * d) * 4
    region = _r16(max(ring, warp_merge, nsplit * 2 * g * 4))
    q = region + _r16(WARPS * depth * 8)
    p = q + _r16(g * d * 4)
    tbl = p + _r16(WARPS * g * SUB * 4)
    return tbl + _r16(pps * 4) + 16


@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("d,esize", [(64, 2), (128, 2), (192, 2), (96, 4),
                                     (128, 4)])
def test_up_to_eight_rows_keep_their_layout(g, d, esize):
    """One sub-group: the state stays in registers, the merge reuses the
    ring, and every size is what it was."""
    assert (sub_groups(g), sub_rows(g), padded_rows(g)) == (1, g, g)
    assert partial_floats(g, d) == g * d + (2 * g + 3) // 4 * 4
    for page, depth, pps, nsplit in ((16, 1, 4, 1), (16, 2, 15, 9),
                                     (8, 4, 4, 300)):
        got = layout(g, d, page, depth, pps, nsplit, esize)
        assert got["merge"] == 0
        assert got["total"] == _layout_before_sub_groups(
            g, d, page, depth, pps, nsplit, esize)


@pytest.mark.parametrize("g,groups,rows", [(9, 2, 5), (13, 2, 7),
                                           (16, 2, 8), (48, 6, 8),
                                           (64, 8, 8), (65, 9, 8)])
def test_sub_groups_cover_g_with_at_most_eight_rows(g, groups, rows):
    assert (sub_groups(g), sub_rows(g)) == (groups, rows)
    assert g <= padded_rows(g) < g + groups


def test_granite_34b_decode_fits_an_h100():
    """B 8, one KV head, G 48, D 128, bf16, blocks of 16 over S 1024:
    16 splits of 4 blocks, one CTA an SM at one ring stage; the warps'
    state sits beside the ring and every region is 16-byte aligned."""
    npb = 1024 // 16
    pps, nsplit = fk.paged_splits(8, 1, npb, SMS)
    assert (pps, nsplit) == (4, 16)
    assert fk.fit_splits(npb, pps, nsplit, lambda *a: 0, OPTIN) == (4, 16)
    one = layout(48, 128, 16, 1, pps, nsplit, 2)
    ring = WARPS * 2 * 16 * 128 * 2
    assert one["merge"] == ring                          # beside the ring
    assert one["region"] == ring + (merge_head(48) + WARPS * 48 * 128) * 4
    assert all(v % 16 == 0 for v in one.values())
    assert OPTIN // 4 < one["total"] <= OPTIN            # one CTA an SM
    assert layout(48, 128, 16, 2, pps, nsplit, 2)["total"] <= OPTIN
    assert partial_floats(48, 128) == 48 * 128 + 96


@pytest.mark.parametrize("g,d,s,want", [
    (48, 128, 1024, (4, 16)),       # fits as planned
    (48, 128, 32768, (4, 512)),     # 223 KB: fits as planned
    (64, 128, 32768, (8, 256))])    # the split merge alone is 264 KB
def test_fit_splits_shrinks_the_split_merge(g, d, s, want):
    """One request (B 1, one KV head) of S tokens in blocks of 16:
    ``fit_splits`` doubles the blocks a split until one CTA fits."""
    npb = s // 16

    def smem(pps, nsplit):
        return layout(g, d, 16, 1, pps, nsplit, 2)["total"]
    plan = fk.paged_splits(1, 1, npb, SMS)
    got = fk.fit_splits(npb, *plan, smem, OPTIN)
    assert got == want
    assert smem(*got) <= OPTIN
    assert got[0] * got[1] >= npb > got[0] * (got[1] - 1)
    if got != plan:
        assert smem(*plan) > OPTIN


@pytest.mark.parametrize("d,esize,ceiling", [(64, 2, 160), (128, 2, 72),
                                             (192, 2, 42), (128, 4, 56)])
def test_rows_a_cta_holds(d, esize, ceiling):
    """The most query rows a KV head may have at one split and one ring
    stage on an H100 (bf16 at D 128: 72, so granite-34b's 48 fit; the
    warps' state grows by 4 x G x D floats); past it the wrapper's depth
    rule raises."""
    def total(g):
        return layout(g, d, 16, 1, 4, 1, esize)["total"]
    assert total(ceiling) <= OPTIN < total(ceiling + 1)
