"""Parity of the port's decoupled ops (``repro_torch.core.decouple``) with
the JAX package's, on the CPU: block searchsorted, the hash-chain walk,
BSR SpMV with ``csr_to_bsr``, and the merge-path merge and merge sort, at
the sizes of ``examples/irregular_suite.py``.

The same numpy inputs, made from a seed, go through the JAX op and the
port's (whose kernel wrappers run their plain versions on CPU tensors).
SpMV and the merges are held against JAX's Pallas kernels in interpret
mode and against its ``method="ref"``.  Searchsorted and the hash walk
are held against ``method="ref"`` only: their Pallas kernels call
``pl.load``, which jax 0.9 no longer has, so they cannot run here.

Tolerances: integer results and merges (a permutation of the input) are
exact; SpMV in float32 within 1e-5 times the largest row sum of
|val * vec| (the two sides add in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.decouple as jd
from repro.kernels.dae_merge.kernel import \
    bitonic_merge_first_half as jax_bitonic
from repro.kernels.dae_merge.ops import merge_path_splits as jax_splits
from repro_torch.core import decouple as td
from repro_torch.core.pipeline import plan_rif
from repro_torch.kernels.common import ring_rif
from repro_torch.kernels.dae_chase import kernel as ck
from repro_torch.kernels.dae_chase.ops import pack_entries
from repro_torch.kernels.dae_chase.ref import (hash_lookup_ref,
                                               searchsorted_ref)
from repro_torch.kernels.dae_merge import kernel as mk
from repro_torch.kernels.dae_merge.ops import merge_path_splits
from repro_torch.kernels.dae_merge.ref import merge_ref
from repro_torch.kernels.dae_spmv import kernel as sk
from repro_torch.kernels.dae_spmv.ref import bsr_spmv_ref, spmv_ref

# JAX method -> the port's: "pallas" runs the kernel there, and here the
# kernel wrapper's plain version (CPU tensors)
METHODS = [("pallas", "kernel"), ("ref", "ref")]
PORT_METHODS = ["kernel", "ref"]
DTYPES = [np.int32, np.float32]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# block searchsorted
# ---------------------------------------------------------------------------


def _search_inputs(dtype, seed=0):
    """A sorted 5000-element table with a run of duplicates across the
    boundary of blocks 0 and 1 (block 128), and 64 keys: table members,
    the duplicate, values between members, and keys below the first and
    above the last entry."""
    rng = np.random.default_rng(seed)
    table = np.sort(rng.integers(0, 1 << 20, 5000)).astype(dtype)
    table[120:140] = table[120]                   # duplicates over 127|128
    keys = table[rng.integers(0, 5000, 64)].copy()
    keys[:8] = [table[0] - 1, table[0], table[120], table[-1],
                table[-1] + 1, table[119] + 0.5 if dtype == np.float32
                else table[119], table[4999] - 1, 1 << 21]
    if dtype == np.float32:
        keys[8:16] = rng.uniform(0, 1 << 20, 8)
    else:
        keys[8:16] = rng.integers(0, 1 << 20, 8)
    return table, keys.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", PORT_METHODS)
def test_searchsorted_matches_jax_ref(dtype, method):
    table, keys = _search_inputs(dtype)
    want = np.asarray(jd.decoupled_searchsorted(
        jnp.asarray(table), jnp.asarray(keys), method="ref"))
    # chunk 24 does not divide the 64 keys
    got = td.decoupled_searchsorted(_t(table), _t(keys), block=128, chunk=24,
                                    method=method)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129])
def test_searchsorted_table_edges(n):
    """Tables shorter than, equal to and just past one block, and empty:
    the padding sentinels never count below a real key."""
    rng = np.random.default_rng(n)
    table = np.sort(rng.integers(-50, 50, n)).astype(np.int32)
    keys = np.array([-100, -50, 0, 49, 100, np.iinfo(np.int32).max],
                    np.int32)
    want = np.asarray(jd.decoupled_searchsorted(
        jnp.asarray(table), jnp.asarray(keys), method="ref"))
    got = td.decoupled_searchsorted(_t(table), _t(keys), block=128, chunk=4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_searchsorted_no_keys():
    table, _ = _search_inputs(np.int32)
    got = td.decoupled_searchsorted(_t(table),
                                    torch.zeros(0, dtype=torch.int32))
    assert got.shape == (0,) and got.dtype == torch.int32


def test_searchsorted_rejects_mixed_dtypes():
    with pytest.raises(TypeError):
        td.decoupled_searchsorted(torch.arange(8, dtype=torch.int32),
                                  torch.zeros(2))


@pytest.mark.parametrize("dtype", DTYPES)
def test_searchsorted_blocks_plain_matches_ref(dtype):
    table, keys = _search_inputs(dtype, seed=1)
    block = 128
    n = table.shape[0]
    pad = np.full(-n % block, np.inf if dtype == np.float32
                  else np.iinfo(np.int32).max, dtype)
    tiles = _t(np.concatenate([table, pad]).reshape(-1, block))
    blk = (torch.searchsorted(tiles[:, 0].contiguous(), _t(keys), right=True)
           - 1).clamp(0, tiles.shape[0] - 1).to(torch.int32)
    got = ck.searchsorted_blocks_plain(tiles, blk, _t(keys), n)
    assert torch.equal(got, searchsorted_ref(_t(table), _t(keys)))


# ---------------------------------------------------------------------------
# hash-chain walk
# ---------------------------------------------------------------------------


def _hash_inputs(seed=0, n=256, chain=4):
    """256 entries in chains of 4, placed by a seeded permutation (chain
    steps are not neighbours), and lookups that hit at every depth, miss,
    start from a dead head (-1) or follow a pointer past the table."""
    rng = np.random.default_rng(seed)
    slot = rng.permutation(n)                     # entry e lives at slot[e]
    ek = np.empty(n, np.int32)
    ev = np.empty(n, np.int32)
    en = np.empty(n, np.int32)
    ek[slot] = np.arange(n) * 7 + 3
    ev[slot] = rng.integers(0, 1 << 20, n)
    nxt = np.where(np.arange(n) % chain == chain - 1, -1,
                   slot[np.minimum(np.arange(n) + 1, n - 1)])
    en[slot] = nxt
    chains = n // chain
    c = rng.integers(0, chains, 61)
    depth = rng.integers(0, chain, 61)
    heads = slot[c * chain].astype(np.int32)
    keys = ek[slot[c * chain + depth]].copy()
    keys[:6] = -5                                 # misses: walk to the end
    heads[6:9] = -1                               # dead heads
    # a chain whose second entry points past the table: the walk reads the
    # last entry (clip) and carries on from its next pointer
    en[slot[chain * 3 + 1]] = n + 17
    heads[9:12] = slot[chain * 3]
    keys[9] = ek[n - 1]
    keys[10] = ek[en[n - 1]] if en[n - 1] >= 0 else -7
    keys[11] = ek[slot[chain * 3 + 1]]
    return ek, ev, en, heads, keys.astype(np.int32)


@pytest.mark.parametrize("method", PORT_METHODS)
@pytest.mark.parametrize("max_steps", [4, 2])
def test_hash_lookup_matches_jax_ref(method, max_steps):
    ek, ev, en, heads, keys = _hash_inputs()
    want = np.asarray(jd.decoupled_hash_lookup(
        *map(jnp.asarray, (ek, ev, en, heads, keys)), max_steps=max_steps,
        method="ref"))
    # chunk 16 does not divide the 61 lookups
    got = td.decoupled_hash_lookup(*map(_t, (ek, ev, en, heads, keys)),
                                   max_steps=max_steps, chunk=16,
                                   method=method)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).sum() >= 9                # misses and dead heads


def test_hash_lookup_example_chains_all_found():
    """The example's contiguous chains: the last entry of every chain."""
    n, chain = 256, 4
    rng = np.random.default_rng(0)
    ek = np.arange(n, dtype=np.int32)
    ev = rng.integers(0, 1 << 20, n).astype(np.int32)
    en = np.array([(i + 1) if (i + 1) % chain else -1 for i in range(n)],
                  np.int32)
    heads = np.arange(0, n, chain, dtype=np.int32)
    want = heads + chain - 1
    got = td.decoupled_hash_lookup(_t(ek), _t(ev), _t(en), _t(heads),
                                   _t(want), max_steps=chain)
    np.testing.assert_array_equal(got.numpy(), ev[want])


def test_hash_lookup_no_lookups():
    ek, ev, en, _, _ = _hash_inputs()
    empty = torch.zeros(0, dtype=torch.int32)
    got = td.decoupled_hash_lookup(_t(ek), _t(ev), _t(en), empty, empty)
    assert got.shape == (0,)


def test_hash_probe_plain_matches_ref():
    ek, ev, en, heads, keys = _hash_inputs(seed=3)
    packed = pack_entries(_t(ek), _t(ev), _t(en))
    assert packed.shape == (256, ck.ENTRY_WORDS)
    assert torch.equal(packed[:, 3], torch.zeros(256, dtype=torch.int32))
    got = ck.hash_probe_plain(packed, _t(heads), _t(keys), max_steps=4)
    want = hash_lookup_ref(_t(ek), _t(ev), _t(en), _t(heads), _t(keys), 4)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# BSR SpMV
# ---------------------------------------------------------------------------


def _csr(seed=0, nrows=64, ncols=4096, nnz=512):
    """The example's random CSR, with rows 8-15 (block row 1) emptied and
    three duplicate entries (same row and column) added."""
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(nnz, np.ones(nrows) / nrows)
    counts[20] += counts[8:16].sum()
    counts[8:16] = 0
    rows = np.zeros(nrows + 1, np.int64)
    rows[1:] = np.cumsum(counts)
    cols = rng.integers(0, ncols, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    lo = rows[20]
    cols[lo + 1] = cols[lo + 2] = cols[lo]        # duplicates in row 20
    vec = rng.standard_normal(ncols).astype(np.float32)
    return rows, cols, val, vec, ncols


def _spmv_limit(rows, cols, val, vec) -> float:
    per_row = np.zeros(len(rows) - 1)
    np.add.at(per_row, np.repeat(np.arange(len(rows) - 1), np.diff(rows)),
              np.abs(val.astype(np.float64) * vec[cols]))
    return 1e-5 * per_row.max()


@pytest.mark.parametrize("bm,bk", [(8, 128), (4, 64)])
def test_csr_to_bsr_matches_jax(bm, bk):
    rows, cols, val, _, ncols = _csr(seed=bm)
    want = jd.csr_to_bsr(rows, cols, val, ncols, bm=bm, bk=bk)
    got = td.csr_to_bsr(rows, cols, val, ncols, bm=bm, bk=bk)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3:] == want[3:]
    for rb in range(8 // bm, 16 // bm):           # the emptied rows 8-15
        sel = got[1] == rb
        assert sel.sum() == 1 and got[2][sel][0] == 0
        assert not got[0][sel].any()


def test_csr_to_bsr_defaults_and_all_empty():
    rows = np.zeros(17, np.int64)
    got = td.csr_to_bsr(rows, np.zeros(0, np.int64), np.zeros(0, np.float32),
                        300)
    want = jd.csr_to_bsr(rows, np.zeros(0, np.int64),
                         np.zeros(0, np.float32), 300, bm=8, bk=128)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3:] == want[3:] == (384, 2)


@pytest.mark.parametrize("jax_method,method", METHODS)
def test_spmv_matches_jax(jax_method, method):
    rows, cols, val, vec, ncols = _csr()
    vb, ri, ci, _, nrb = td.csr_to_bsr(rows, cols, val, ncols)
    want = np.asarray(jd.decoupled_spmv(
        jnp.asarray(vb), jnp.asarray(ri), jnp.asarray(ci), jnp.asarray(vec),
        nrb, rif=2, method=jax_method, interpret=True))
    got = td.decoupled_spmv(_t(vb), _t(ri), _t(ci), _t(vec), nrb,
                            method=method).numpy()
    limit = _spmv_limit(rows, cols, val, vec)
    np.testing.assert_allclose(got, want, rtol=0, atol=limit)
    np.testing.assert_allclose(got[:64], spmv_ref(
        _t(rows), _t(cols), _t(val), _t(vec)).numpy(), rtol=0, atol=limit)
    assert not got[8:16].any()                    # the empty block row


def test_spmv_pads_a_ragged_vector():
    rows, cols, val, vec, _ = _csr(seed=5, ncols=1000)
    vb, ri, ci, pad_to, nrb = td.csr_to_bsr(rows, cols, val, 1000)
    assert pad_to == 1024
    got = td.decoupled_spmv(_t(vb), _t(ri), _t(ci), _t(vec), nrb)
    want = jd.decoupled_spmv(jnp.asarray(vb), jnp.asarray(ri),
                             jnp.asarray(ci), jnp.asarray(vec), nrb,
                             method="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=_spmv_limit(rows, cols, val, vec))


def test_bsr_spmv_plain_matches_ref():
    rows, cols, val, vec, ncols = _csr(seed=2)
    vb, ri, ci, _, nrb = td.csr_to_bsr(rows, cols, val, ncols)
    tiles = _t(vec).reshape(-1, 128)
    got = sk.bsr_spmv_plain(_t(vb), _t(ri), _t(ci), tiles, nrb)
    assert torch.equal(got, bsr_spmv_ref(_t(vb), _t(ri), _t(ci), tiles, nrb))
    assert got.shape == (nrb, 8)


# ---------------------------------------------------------------------------
# merge-path merge and merge sort
# ---------------------------------------------------------------------------


def _runs(dtype, n, m, seed):
    """Two sorted runs of lengths n and m over a small value range, so
    ties within and across the runs are common."""
    rng = np.random.default_rng(seed)
    a = np.sort(rng.integers(0, 40, n)).astype(dtype)
    b = np.sort(rng.integers(0, 40, m)).astype(dtype)
    return a, b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m", [(300, 77), (77, 300), (0, 200), (200, 0),
                                 (128, 128)])
@pytest.mark.parametrize("jax_method,method", METHODS)
def test_merge_matches_jax(dtype, n, m, jax_method, method):
    a, b = _runs(dtype, n, m, seed=n * 1000 + m)
    want = np.asarray(jd.decoupled_merge(jnp.asarray(a), jnp.asarray(b),
                                         tile=64, rif=2, method=jax_method,
                                         interpret=True))
    got = td.decoupled_merge(_t(a), _t(b), tile=64, method=method)
    assert got.dtype == _t(a).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("jax_method,method", METHODS)
def test_merge_sort_matches_jax(dtype, jax_method, method):
    """1000 elements at tile 128: N is not a multiple of the tile, and the
    passes merge runs of 128, 256 and 512 (the last pair of the first
    passes ends in sentinels)."""
    rng = np.random.default_rng(7)
    if dtype == np.float32:
        x = rng.standard_normal(1000).astype(np.float32)
    else:
        x = rng.integers(0, 1 << 30, 1000).astype(np.int32)
    x[:10] = x[10]                                # ties
    want = np.asarray(jd.decoupled_merge_sort(jnp.asarray(x), tile=128,
                                              method=jax_method,
                                              interpret=True))
    got = td.decoupled_merge_sort(_t(x), tile=128, method=method)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 128, 129, 640])
def test_merge_sort_lengths(n):
    """Lengths of no, one and five tiles and just past one: an odd number
    of runs leaves a run without a pair in some passes."""
    x = np.random.default_rng(n).integers(-99, 99, n).astype(np.int32)
    got = td.decoupled_merge_sort(_t(x), tile=128)
    np.testing.assert_array_equal(got.numpy(), np.sort(x))


@pytest.mark.parametrize("n,m,tile", [(300, 77, 64), (0, 50, 16),
                                      (1000, 1, 128)])
def test_merge_path_splits_match_jax(n, m, tile):
    a, b = _runs(np.int32, n, m, seed=tile)
    n_tiles = -(-(n + m) // tile)
    want = jax_splits(jnp.asarray(a), jnp.asarray(b), tile, n_tiles)
    got = merge_path_splits(_t(a), _t(b), tile, n_tiles)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", DTYPES)
def test_bitonic_merge_first_half_matches_jax(dtype):
    """The port merges a tile's windows serially (ties from a first)
    where the reference runs its network on a ++ reversed(b): the same
    T smallest."""
    a, b = _runs(dtype, 64, 64, seed=11)
    v = np.concatenate([a, b[::-1]])
    want = np.asarray(jax_bitonic(jnp.asarray(v)))
    z = torch.zeros(1, dtype=torch.int32)
    got = mk.merge_tiles_plain(_t(a), _t(b), z, z + 64, z, z + 64, 64,
                               tile=64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.sort(v)[:64])


@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_tiles_plain_matches_ref(dtype):
    """Tiles whose windows run past their run's end read sentinels."""
    a, b = _runs(dtype, 200, 130, seed=3)
    tile = 32
    n_tiles = -(-330 // tile)
    ia, ib = merge_path_splits(_t(a), _t(b), tile, n_tiles)
    got = mk.merge_tiles_plain(_t(a), _t(b), ia, torch.full_like(ia, 200),
                               ib, torch.full_like(ib, 130), 330, tile=tile)
    assert torch.equal(got, merge_ref(_t(a), _t(b)))


def test_merge_rejects_mixed_dtypes():
    with pytest.raises(TypeError):
        td.decoupled_merge(torch.zeros(4), torch.zeros(4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# API, knobs and devices
# ---------------------------------------------------------------------------


def test_public_api_mirrors_the_reference():
    """Every op the reference exports is exported under its name; its
    TPU ring emitter has its Hopper form in csrc/ring.cuh instead."""
    emitter = {"RingChannel", "access_execute", "ring_step",
               "ring_scratch_shapes"}
    assert set(td.__all__) == set(jd.__all__) - emitter
    assert all(callable(getattr(td, name)) for name in td.__all__)
    assert "ring.cuh" in td.__doc__


@pytest.mark.parametrize("block_bytes", [16, 512, 1024, 4608])
def test_ring_rif_resolves_explicit_then_plan(block_bytes):
    assert ring_rif(3, block_bytes) == 3
    assert ring_rif(None, block_bytes) == plan_rif(block_bytes).rif


def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    fns = (ck.searchsorted_blocks, ck.hash_probe, sk.bsr_spmv, mk.merge_tiles)
    before = [f.launches for f in fns]
    table, keys = _search_inputs(np.int32)
    td.decoupled_searchsorted(_t(table), _t(keys))
    td.decoupled_hash_lookup(*map(_t, _hash_inputs()), max_steps=4)
    rows, cols, val, vec, ncols = _csr()
    vb, ri, ci, _, nrb = td.csr_to_bsr(rows, cols, val, ncols)
    td.decoupled_spmv(_t(vb), _t(ri), _t(ci), _t(vec), nrb)
    td.decoupled_merge_sort(torch.arange(300, 0, -1, dtype=torch.int32),
                            tile=64)
    assert [f.launches for f in fns] == before


def test_non_cpu_tensors_never_fall_back_to_the_plain_versions():
    """A tensor that is not on the CPU must launch the kernel or raise;
    here meta tensors (neither CPU nor CUDA) must raise."""
    def meta(*shape, dtype=torch.int32):
        return torch.zeros(*shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError):
        ck.searchsorted_blocks(meta(4, 128), meta(3), meta(3), 500)
    with pytest.raises(ValueError):
        ck.hash_probe(meta(8, 4), meta(3), meta(3), max_steps=2)
    with pytest.raises(ValueError):
        sk.bsr_spmv(meta(2, 8, 128, dtype=torch.float32), meta(2), meta(2),
                    meta(4, 128, dtype=torch.float32), 2)
    with pytest.raises(ValueError):
        mk.merge_tiles(meta(8), meta(8), meta(2), meta(2), meta(2), meta(2),
                       16, tile=8)


def test_unknown_methods_raise():
    t = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        td.decoupled_searchsorted(t, t, method="pallas")
    with pytest.raises(ValueError):
        td.decoupled_merge(t, t, method="pallas")
    with pytest.raises(ValueError):
        td.decoupled_merge_sort(t, method="bogus")
    with pytest.raises(ValueError):
        td.decoupled_hash_lookup(t, t, t, t, t, method="pallas")
    with pytest.raises(ValueError):
        td.decoupled_spmv(torch.zeros(1, 8, 128), t[:1], t[:1],
                          torch.zeros(128), 1, method="pallas")
