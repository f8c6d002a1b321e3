"""The bf16 grouped-matmul kernel's schedule on the CPU.

``csrc/grouped_matmul.cu`` runs only on the card.  This file mirrors its
order of work in torch: the work list of items (token block, 128-row
slice, column tile of ``bn``) with the tile fastest; per block, on the
device, the path from ``block_rows`` (wide: more than 64
real rows, both warpgroups multiply 64 rows each and the producer
fetches the 128 rows in two 64-row boxes; narrow: 1 to 64 real rows,
only the first warpgroup multiplies and the producer fetches
round_up(real, 16) rows in 16-row boxes; none: no fetch at all); stages
64 deep in D, zero past D, T and F as TMA fills them, and the rows of a
stage's x tile that no box filled holding stale values (NaN here, which
must never reach the output); exact zeros for the rows past a block's
real ones.

The mirror is held to the JAX package's ``grouped_matmul`` (its Pallas
kernel in interpret mode) on the same bf16-rounded float32 inputs, at
granite-moe-3b-a800m's decode layout (D 1536, F 512, 40 experts top-8,
bt 128, built by ``moe.block_layout``), at small ragged cases (bt 16,
128 and 256; D and F off the stage and the tile) and at blocks made
narrow, wide or both, within 1e-5 absolute
plus 1e-5 relative: both sum float32 products of the same values, in
another order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul.ops import grouped_matmul as jax_gmm
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.grouped_matmul import kernel as mk
from repro_torch.models import moe

DEPTH = mk.STAGE_DEPTH           # D of one stage
ROWS = mk.SLICE_ROWS             # rows of a slice
NARROW = 64                      # real rows up to which a block is narrow
BOX16, BOX64 = 16, 64            # x rows per TMA box, narrow and wide
RTOL = ATOL = 1e-5

# (tokens routed, E, top-k, D, F, bt): granite's decode, then ragged ones
CASES = {
    "granite_decode": (8, 40, 8, 1536, 512, 128),
    "bt16_ragged": (20, 5, 2, 72, 40, 16),
    "bt128_ragged": (90, 4, 2, 200, 328, 128),
    "bt256": (150, 3, 2, 96, 264, 256),
}
# block layouts whose real rows make every block narrow (1 to 64), every
# block wide (65 to 128), or both with empty blocks: (E, D, F, bt, blocks)
LAYOUTS = {"narrow": (1, 65), "wide": (65, 129), "mixed": (0, 129)}
LAYOUT_SHAPE = (4, 136, 72, 128, 6)


@functools.lru_cache(maxsize=None)
def _case(name):
    """bf16-rounded float32 inputs laid out as the MoE dispatch lays them
    out: every expert group padded to whole blocks with zero rows."""
    tokens, e, k, d, f, bt = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    experts = np.argsort(rng.random((tokens, e)), axis=1)[:, :k]
    _, se, stok, counts, pos = moe.sort_pairs(
        torch.from_numpy(experts.astype(np.int32)), e)
    tp, starts, be, rows = moe.block_layout(counts, tokens * k, bt)
    x = torch.from_numpy(rng.standard_normal((tokens, d)).astype(np.float32))
    xs = torch.zeros((tp, d))
    xs[starts[se] + pos] = x[stok]
    w = torch.from_numpy(
        (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32))
    xs, w = xs.bfloat16().float(), w.bfloat16().float()
    return xs, w, be, rows, bt


@functools.lru_cache(maxsize=None)
def _jax(name):
    xs, w, be, _, bt = _case(name)
    return torch.from_numpy(np.asarray(jax_gmm(
        jnp.asarray(xs.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(be.numpy()), bt=bt, method="pallas", interpret=True)))


def _rows_of(src, first, n):
    """Rows first .. first + n - 1 of src, zeros past its end (TMA's
    fill)."""
    out = torch.zeros((n, src.shape[1]))
    part = src[first:first + n]
    out[:part.shape[0]] = part
    return out


def mirror(x, w, be, rows, bt, bn):
    """The kernel's result in float32 (before its bf16 rounding), the
    path each item took beside its slice's real rows, and every
    weight-tile fetch (block, slice, tile, stage) in issue order."""
    t, d = x.shape
    f = w.shape[2]
    slices, n_tiles = cdiv(bt, ROWS), cdiv(f, bn)
    out = torch.full((t, f), float("nan"))
    paths, fetches = [], []
    for i in range(be.shape[0] * slices * n_tiles):
        tile, r = i % n_tiles, i // n_tiles
        sl, blk = r % slices, r // slices
        r0 = sl * ROWS
        row0 = blk * bt + r0
        n_rows = max(0, min(ROWS, bt - r0, t - row0))
        real = max(0, min(n_rows, int(rows[blk]) - r0))
        nk = cdiv(d, DEPTH) if real else 0
        n0 = tile * bn
        cols = min(bn, f - n0)
        out[row0 + real:row0 + n_rows, n0:n0 + cols] = 0.0   # padding rows
        if nk == 0:
            paths.append((real, "none"))
            continue
        wide = real > NARROW
        paths.append((real, "wide" if wide else "narrow"))
        # x rows the producer fetches; the rest of the stage is stale
        fetched = 2 * BOX64 if wide else cdiv(real, BOX16) * BOX16
        ex = min(max(int(be[blk]), 0), w.shape[0] - 1)
        acc = torch.zeros((ROWS, bn))
        xr = _rows_of(x, row0, fetched)
        for k in range(nk):
            k0 = k * DEPTH
            fetches.append((blk, sl, tile, k))
            xs = torch.full((ROWS, DEPTH), float("nan"))
            xs[:fetched] = 0.0
            xt = xr[:, k0:k0 + DEPTH]
            xs[:fetched, :xt.shape[1]] = xt
            ws = torch.zeros((DEPTH, bn))
            wt = w[ex, k0:k0 + DEPTH, n0:n0 + bn]
            ws[:wt.shape[0], :wt.shape[1]] = wt
            # the first warpgroup always multiplies; the second only for
            # a wide block
            mine = ROWS if wide else NARROW
            acc[:mine] += xs[:mine] @ ws
        out[row0:row0 + real, n0:n0 + cols] = acc[:real, :cols]
    return out, paths, fetches


def _pad_mask(t, bt, rows):
    r = torch.arange(t)
    return r % bt >= rows[r // bt].long()


@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mirror_matches_jax(case, bn):
    xs, w, be, rows, bt = _case(case)
    got, paths, _ = mirror(xs, w, be, rows, bt, bn)
    want = _jax(case)
    assert torch.isfinite(got).all()       # no stale row reaches the output
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert bool((got[_pad_mask(xs.shape[0], bt, rows)] == 0).all())
    # decode's blocks (1 to 8 real rows) all take the narrow path, the
    # 256-row blocks' first slices (about 100 real rows) the wide one
    taken = {path for _, path in paths}
    if case == "granite_decode":
        assert taken == {"narrow", "none"}
    if case == "bt256":
        assert "wide" in taken


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_weight_fetch_for_blocks_without_real_rows(case):
    xs, w, be, rows, bt = _case(case)
    d, f = xs.shape[1], w.shape[2]
    _, _, fetches = mirror(xs, w, be, rows, bt, 256)
    fetched = {}
    for blk, sl, tile, k in fetches:
        fetched.setdefault((blk, sl, tile), []).append(k)
    for blk in range(be.shape[0]):
        for sl in range(cdiv(bt, ROWS)):
            real = max(0, min(ROWS, bt - sl * ROWS,
                              int(rows[blk]) - sl * ROWS))
            for tile in range(cdiv(f, 256)):
                # each stage of D once, in order, or nothing at all
                assert fetched.get((blk, sl, tile), []) == (
                    list(range(cdiv(d, DEPTH))) if real else [])


@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_path_per_block_follows_block_rows(layout, bn):
    """Blocks of 1 to 64 real rows take the narrow path, 65 to 128 the
    wide one, none fetches nothing; the result is JAX's either way, with
    every padding row zero."""
    e, d, f, bt, nb = LAYOUT_SHAPE
    rng = np.random.default_rng(sum(map(ord, layout)) + bn)
    lo, hi = LAYOUTS[layout]
    rows = rng.integers(lo, hi, nb).astype(np.int32)
    if layout == "mixed":
        rows[:4] = [0, 64, 65, 128]
    be = rng.integers(0, e, nb).astype(np.int32)
    x = rng.standard_normal((nb * bt, d)).astype(np.float32)
    x[np.arange(nb * bt) % bt >= rows[np.arange(nb * bt) // bt]] = 0.0
    w = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    x = torch.from_numpy(x).bfloat16().float()
    w = torch.from_numpy(w).bfloat16().float()
    be, rows = torch.from_numpy(be), torch.from_numpy(rows)
    got, paths, _ = mirror(x, w, be, rows, bt, bn)
    want = torch.from_numpy(np.asarray(jax_gmm(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(be.numpy()), bt=bt, method="pallas", interpret=True)))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert bool((got[_pad_mask(x.shape[0], bt, rows)] == 0).all())
    n_tiles = cdiv(f, bn)
    assert [p for _, p in paths] == [
        "none" if r == 0 else "narrow" if r <= NARROW else "wide"
        for r in rows.tolist() for _ in range(n_tiles)]


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    xs, w, be, rows, bt = _case("bt128_ragged")
    before = mk.gmm.launches
    got = mk.gmm(xs, w, be, bt=bt, block_rows=rows)
    assert mk.gmm.launches == before
    torch.testing.assert_close(got, mk.gmm_plain(xs, w, be, bt=bt,
                                                 block_rows=rows))
