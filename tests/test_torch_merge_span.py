"""The span-streaming merge kernel's schedule on the CPU.

``csrc/dae_merge.cu`` runs only on the card.  This file mirrors its work
in numpy, step for step: the spans of ``span_tiles(tile)`` tiles; the
producer's union of each run's windows, one interval where the runs are
one tensor and the unions touch, laid out in a stage of
``stage_bytes(tile, span)`` bytes, each interval loaded as a bulk copy of
its 16-byte-aligned interior plus at most 3 + 3 four-byte edge copies;
the choice between that span path and the per-tile path (the unions do
not fit the stage); and each consumer thread's diagonal search (the
smallest i with A[i] > B[k - i - 1]) and serial merge of its
``MERGE_K`` outputs, ties from a first.  The mirror asserts the
schedule's invariants: every byte of an interval is loaded once, nothing
outside it is read, bulk copies are 16-byte aligned on both sides, a
consumer reads only loaded stage elements, every output is written once.

Its result is held exactly against JAX's ``merge_tiles`` in interpret
mode, on runs padded with sentinels as the reference pads them.  The
reference's windows have no per-tile ends, so where a tile's window stops
at its own run's end (a sort pass, arbitrary ends) the JAX kernel is
given each tile's window, padded, as its own run.

Equal keys: int32 keys compare bit for bit.  float32 -0.0 and +0.0
compare equal; the merge takes ties from a first (the reference's split
rule), while JAX's network orders -0.0 before +0.0 (its minimum is
IEEE's), so the two place zeros differently and there the test compares
values, and the mirror's bits against a stable sort of each tile's
windows (a first) and against the port's plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dae_merge.kernel import merge_tiles as jax_merge_tiles
from repro_torch.kernels.dae_merge import kernel as mk
from repro_torch.kernels.dae_merge.ops import merge_path_splits

BASE = 1 << 12          # a 16-byte-aligned address the mirror places runs at


def _big(dtype):
    return np.inf if dtype == np.float32 else np.iinfo(np.int32).max


def _floor16(x):
    return x & ~15


def _ceil16(x):
    return (x + 15) & ~15


def merge_mirror(a, b, sa, ea, sb, eb, n_out, tile, *, off_a=0, off_b=0,
                 same=False, stage=None):
    """dae_merge.cu's result and the path each span took.  ``off_a`` /
    ``off_b``: the runs' byte addresses past a 16-byte boundary (a view's
    misalignment); ``same``: a and b are one tensor (then b is a);
    ``stage``: stage bytes, ``stage_bytes(tile, span)`` by default."""
    big = _big(a.dtype)
    span = mk.span_tiles(tile)
    stage = stage or mk.stage_bytes(tile, span)
    kk = min(mk.MERGE_K, tile)
    n_tiles = len(sa)
    addr_a = BASE + off_a
    addr_b = addr_a if same else BASE + (1 << 30) + off_b
    if same:
        b = a
    out = np.zeros(n_tiles * tile, a.dtype)
    written = np.zeros(n_tiles * tile, np.int64)
    modes = []
    for s0 in range(0, n_tiles, span):
        ts = range(s0, min(s0 + span, n_tiles))
        na = {t: int(np.clip(ea[t] - sa[t], 0, tile)) for t in ts}
        nb = {t: int(np.clip(eb[t] - sb[t], 0, tile)) for t in ts}
        ta = [t for t in ts if na[t] > 0]
        tb = [t for t in ts if nb[t] > 0]
        ivs = []                                    # (tensor, lo, hi)
        if ta:
            ivs.append(["a", min(sa[t] for t in ta),
                        max(sa[t] + na[t] for t in ta)])
        if tb:
            lo_b = min(sb[t] for t in tb)
            hi_b = max(sb[t] + nb[t] for t in tb)
            if ta and same and lo_b <= ivs[0][2] and ivs[0][1] <= hi_b:
                ivs[0][1] = min(ivs[0][1], lo_b)
                ivs[0][2] = max(ivs[0][2], hi_b)
            else:
                ivs.append(["b", lo_b, hi_b])
        src = {"a": (a, addr_a), "b": (b, addr_b)}
        layout, total = [], 0
        for name, lo, hi in ivs:
            g = src[name][1]
            base = _floor16(g + 4 * lo)
            layout.append((name, lo, hi, base, total))
            total += _ceil16(g + 4 * hi) - base
        fits = total <= stage

        def window(name, start):
            """The stage index of a window: a's in the first interval,
            b's in the second where there are two (the kernel's rule)."""
            _, _, _, base, off = layout[1 if name == "b" and
                                        len(layout) == 2 else 0]
            return (off + src[name][1] + 4 * start - base) // 4

        if fits:
            modes.append("span")
            buf = np.zeros(stage // 4, a.dtype)
            loaded = np.zeros(stage // 4, np.int64)
            for name, lo, hi, base, off in layout:
                x, g = src[name]
                assert 0 <= lo < hi <= len(x)       # nothing outside the run
                c0, c1 = _ceil16(g + 4 * lo), _floor16(g + 4 * hi)
                edges = []
                if c1 > c0:                         # the bulk copy
                    assert (c0 - base + off) % 16 == 0 and c0 % 16 == 0
                    assert (c1 - c0) % 16 == 0
                    p0, p1 = (c0 - g) // 4, (c1 - g) // 4
                    dst = (off + c0 - base) // 4
                    buf[dst:dst + p1 - p0] = x[p0:p1]
                    loaded[dst:dst + p1 - p0] += 1
                    edges = [*range(lo, p0), *range(p1, hi)]
                else:
                    edges = list(range(lo, hi))
                assert len(edges) <= 8                # one lane each
                for pos in edges:
                    dst = (off + g + 4 * pos - base) // 4
                    buf[dst] = x[pos]
                    loaded[dst] += 1
                first = (off + g + 4 * lo - base) // 4
                assert (loaded[first:first + hi - lo] == 1).all()
            assert loaded.sum() == sum(hi - lo for _, lo, hi, _, _ in layout)
        else:
            modes.append("per-tile")
        for t in ts:
            if fits:
                wa = window("a", sa[t]) if na[t] else 0
                wb = window("b", sb[t]) if nb[t] else 0
                win_a = [buf[wa + i] if i < na[t] else big
                         for i in range(tile)]
                win_b = [buf[wb + j] if j < nb[t] else big
                         for j in range(tile)]
                for i in range(na[t]):
                    assert loaded[wa + i] == 1
                for j in range(nb[t]):
                    assert loaded[wb + j] == 1
            else:                                   # loaded by the consumers
                win_a = [a[sa[t] + i] if i < na[t] else big
                         for i in range(tile)]
                win_b = [b[sb[t] + j] if j < nb[t] else big
                         for j in range(tile)]
            for k in range(0, tile, kk):            # one consumer thread
                lo, hi = 0, k
                while lo < hi:
                    mid = (lo + hi) // 2
                    if win_a[mid] <= win_b[k - mid - 1]:
                        lo = mid + 1
                    else:
                        hi = mid
                i, j = lo, k - lo
                for u in range(kk):
                    x = win_a[i] if i < tile else big
                    y = win_b[j] if j < tile else big
                    pos = t * tile + k + u
                    if not y < x:
                        out[pos], i = x, i + 1
                    else:
                        out[pos], j = y, j + 1
                    written[pos] += 1
    assert (written == 1).all()
    return out[:n_out], modes


def _stable_oracle(a, b, sa, ea, sb, eb, n_out, tile):
    """Each tile's windows concatenated (a first) and stably sorted: the
    T smallest, ties from a first."""
    big = _big(a.dtype)
    out = []
    for t in range(len(sa)):
        wa = np.full(tile, big, a.dtype)
        wb = np.full(tile, big, a.dtype)
        na = int(np.clip(ea[t] - sa[t], 0, tile))
        nb = int(np.clip(eb[t] - sb[t], 0, tile))
        wa[:na] = a[sa[t]:sa[t] + na]
        wb[:nb] = b[sb[t]:sb[t] + nb]
        w = np.concatenate([wa, wb])
        out.append(w[np.argsort(w, kind="stable")[:tile]])
    return np.concatenate(out)[:n_out]


def _jax_windows(a, b, sa, ea, sb, eb, n_out, tile):
    """JAX's merge_tiles on each tile's own windows, padded with
    sentinels: the reference's kernel on the per-tile-end contract."""
    big = _big(a.dtype)
    n_tiles = len(sa)

    def padded(x, s, e):
        rows = np.full((n_tiles + 1, tile), big, x.dtype)
        for t in range(n_tiles):
            n = int(np.clip(e[t] - s[t], 0, tile))
            rows[t, :n] = x[s[t]:s[t] + n]
        return rows.reshape(-1)

    starts = np.arange(n_tiles, dtype=np.int32) * tile
    got = jax_merge_tiles(jnp.asarray(padded(a, sa, ea)),
                          jnp.asarray(padded(b, sb, eb)),
                          jnp.asarray(starts), jnp.asarray(starts),
                          n_tiles * tile, tile=tile, interpret=True)
    return np.asarray(got)[:n_out]


def _runs(rng, sizes, dtype, zeros=False):
    """Sorted runs with many ties; float runs with ``zeros`` hold -0.0
    and +0.0 in a random order among their zeros."""
    runs = []
    for n in sizes:
        x = np.sort(rng.integers(-30, 30, n)).astype(dtype)
        if zeros:
            x = np.where((x == 0) & (rng.random(n) < 0.5), -0.0, x)
            x = x.astype(dtype)
        runs.append(x)
    return runs


def _check(got, want, oracle, dtype):
    """Bits where keys are bits; values, and the stable order's bits,
    where float zeros may land in either order."""
    if dtype == np.int32:
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(got, want)            # values: -0 == +0
    nonzero = want != 0
    np.testing.assert_array_equal(got.view(np.int32)[nonzero],
                                  want.view(np.int32)[nonzero])
    np.testing.assert_array_equal(got.view(np.int32), oracle.view(np.int32))


def _plain(a, b, sa, ea, sb, eb, n_out, tile):
    t = [torch.from_numpy(np.ascontiguousarray(v)) for v in
         (a, b, sa, ea, sb, eb)]
    return mk.merge_tiles_plain(*t, n_out, tile=tile).numpy()


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("tile", [64, 256])
@pytest.mark.parametrize("n,m,off_a,off_b", [(1500, 1100, 0, 4),
                                             (3001, 7, 12, 0),
                                             (0, 900, 8, 8)])
def test_two_run_merge_matches_jax(dtype, tile, n, m, off_a, off_b):
    rng = np.random.default_rng(n + m + tile)
    a, b = _runs(rng, (n, m), dtype, zeros=dtype == np.float32)
    n_tiles = -(-(n + m) // tile)
    ia, ib = merge_path_splits(torch.from_numpy(a), torch.from_numpy(b),
                               tile, n_tiles)
    sa, sb = ia.numpy(), ib.numpy()
    ea = np.full(n_tiles, n, np.int32)
    eb = np.full(n_tiles, m, np.int32)
    got, modes = merge_mirror(a, b, sa, ea, sb, eb, n + m, tile,
                              off_a=off_a, off_b=off_b)
    assert set(modes) == {"span"}          # merge-path spans always fit
    big = _big(dtype)
    want = np.asarray(jax_merge_tiles(
        jnp.asarray(np.concatenate([a, np.full(tile, big, dtype)])),
        jnp.asarray(np.concatenate([b, np.full(tile, big, dtype)])),
        jnp.asarray(sa), jnp.asarray(sb), n_tiles * tile, tile=tile,
        interpret=True))[:n + m]
    oracle = _stable_oracle(a, b, sa, ea, sb, eb, n + m, tile)
    _check(got, want, oracle, dtype)
    np.testing.assert_array_equal(
        got.view(np.int32), _plain(a, b, sa, ea, sb, eb, n + m,
                                   tile).view(np.int32))


def _sort_pass(x, tile, width):
    """A merge-sort pass's splits over ``x`` (runs of ``width``), as
    ``kernels/dae_merge/ops.py::merge_sort`` computes them."""
    from repro_torch.kernels.dae_merge.ops import _split_search
    xp = torch.from_numpy(x)
    padded = x.shape[0]
    k = torch.arange(padded // tile, dtype=torch.int64) * tile
    a0 = k // (2 * width) * (2 * width)
    ks = k - a0
    na = (padded - a0).clamp(max=width)
    b0 = a0 + width
    nb = (padded - b0).clamp(0, width)
    ia = _split_search(xp, a0, na, xp, b0, nb, ks, 2 * width)
    return [v.to(torch.int32).numpy() for v in
            (a0 + ia, a0 + na, b0 + ks - ia, b0 + nb)]


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("mult", [1, 2, 4])
def test_sort_pass_layouts_match_jax(dtype, mult):
    """One tensor as both runs with per-tile ends, runs of width tile, 2
    tile and 4 tile (the last pair ragged): spans that hold whole pairs
    load one interval."""
    tile = 64
    width = mult * tile
    rng = np.random.default_rng(mult)
    n = 40 * tile
    x = np.concatenate(_runs(rng, [width] * (n // width), dtype,
                             zeros=dtype == np.float32))
    sa, ea, sb, eb = _sort_pass(x, tile, width)
    got, modes = merge_mirror(x, x, sa, ea, sb, eb, n, tile, off_a=4,
                              same=True)
    assert set(modes) == {"span"}
    want = _jax_windows(x, x, sa, ea, sb, eb, n, tile)
    oracle = _stable_oracle(x, x, sa, ea, sb, eb, n, tile)
    _check(got, want, oracle, dtype)
    np.testing.assert_array_equal(
        got.view(np.int32), _plain(x, x, sa, ea, sb, eb, n,
                                   tile).view(np.int32))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("tile", [8, 64])
def test_any_starts_take_the_per_tile_path(dtype, tile):
    """Starts that are not merge-path splits, with arbitrary ends: spans
    whose windows lie far apart take the per-tile path, spans of nearby
    windows the span path; n_out ragged."""
    rng = np.random.default_rng(tile)
    n, m = 20_000, 15_000                      # unions past a stage
    a, b = _runs(rng, (n, m), dtype, zeros=dtype == np.float32)
    n_tiles = 3 * mk.span_tiles(tile)
    sa = rng.integers(0, n, n_tiles).astype(np.int32)
    sb = rng.integers(0, m, n_tiles).astype(np.int32)
    near = mk.span_tiles(tile)                 # the first span: nearby
    sa[:near] = np.arange(near) * 3
    sb[:near] = np.arange(near) * 2
    ea = np.full(n_tiles, n, np.int32)
    eb = rng.integers(0, m + 1, n_tiles).astype(np.int32)
    n_out = n_tiles * tile - 3
    got, modes = merge_mirror(a, b, sa, ea, sb, eb, n_out, tile, off_b=4)
    assert modes[0] == "span" and "per-tile" in modes
    want = _jax_windows(a, b, sa, ea, sb, eb, n_out, tile)
    oracle = _stable_oracle(a, b, sa, ea, sb, eb, n_out, tile)
    _check(got, want, oracle, dtype)
    np.testing.assert_array_equal(
        got.view(np.int32), _plain(a, b, sa, ea, sb, eb, n_out,
                                   tile).view(np.int32))


def test_skewed_runs_overflow_a_small_stage():
    """At a stage smaller than the rule's, a span where both runs
    interleave (a window's overhang in each) overflows and takes the
    per-tile path, while a span fed by one run alone (the other
    exhausted) fits: the result is the same."""
    tile = 64
    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 100, 3000)).astype(np.int32)
    b = np.sort(np.concatenate([rng.integers(0, 100, 3000),
                                rng.integers(100, 200, 3000)])
                ).astype(np.int32)
    n, m = len(a), len(b)
    n_tiles = -(-(n + m) // tile)
    ia, ib = merge_path_splits(torch.from_numpy(a), torch.from_numpy(b),
                               tile, n_tiles)
    sa, sb = ia.numpy(), ib.numpy()
    ea, eb = np.full(n_tiles, n, np.int32), np.full(n_tiles, m, np.int32)
    stage = (mk.span_tiles(tile) * tile + tile // 2) * 4
    got, modes = merge_mirror(a, b, sa, ea, sb, eb, n + m, tile, stage=stage)
    assert modes[0] == "per-tile" and modes[-1] == "span"
    big = _big(np.int32)
    want = np.asarray(jax_merge_tiles(
        jnp.asarray(np.concatenate([a, np.full(tile, big, np.int32)])),
        jnp.asarray(np.concatenate([b, np.full(tile, big, np.int32)])),
        jnp.asarray(sa), jnp.asarray(sb), n_tiles * tile, tile=tile,
        interpret=True))[:n + m]
    np.testing.assert_array_equal(got, want)


def test_stage_holds_a_merge_path_span_and_a_per_tile_round():
    """stage_bytes covers a span's unions under merge-path splits ((span
    + 1) tiles and 16-byte rounding of two intervals) and one round of
    the per-tile path (every consumer thread's tile's two windows)."""
    for tile in (2, 4, 8, 64, 256, 1024):
        span = mk.span_tiles(tile)
        assert 1 <= span <= mk.MAX_SPAN
        kk = min(mk.MERGE_K, tile)
        per_round = mk.CONSUMERS // (tile // kk)
        sb = mk.stage_bytes(tile, span)
        assert sb % 16 == 0
        assert sb >= (span + 1) * tile * 4 + 2 * 2 * 12
        assert sb >= per_round * 2 * tile * 4
