"""The block search's unit probes on the CPU.

``csrc/dae_chase.cu``'s ``searchsorted_kernel`` runs only on the card.
This file mirrors what it does: the host plan the wrapper hands it
(:func:`~repro_torch.kernels.dae_chase.kernel.search_plan`: levels, keys
in flight, CTAs), the kernel's walk over the keys (one-warp CTAs of
``chunk`` keys, passes of 32 / L x K keys, key ``p + j * G + g`` to lane
group g, L = 4 lanes a 64-byte unit), and its probe order: each key
reads the unit in the middle of the units left, counts the unit's
elements ``<= key`` (its L lanes' 16-byte slices, a slice past the
block's end counting nothing) and keeps the left units, the right units
or stops inside the unit.
The mirror checks the walk's invariants (each key once; each read a
whole unit inside the key's block, at most ``levels`` of them) and its
result, exactly, against the JAX package's ``searchsorted_ref``
(``jnp.searchsorted``, side right) and its ``decoupled_searchsorted``
``method="ref"`` path.  JAX's Pallas ``searchsorted_blocks`` needs
``pl.load``, gone in jax 0.9, so the oracle is the ref.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.decouple as jd
from repro.kernels.dae_chase.ref import searchsorted_ref as jax_ref
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.dae_chase import kernel as ck

INT_MAX = np.iinfo(np.int32).max
LANES = ck.SEARCH_UNIT_BYTES // 16        # lanes a key
E = ck.SEARCH_UNIT_BYTES // 4             # elements a unit


def walk(m, chunk, plan):
    """The (CTA, pass, j, group) of every key, in the kernel's order:
    each key of the M once."""
    groups = 32 // LANES
    seen = np.zeros(m, np.int64)
    assert plan.ctas == cdiv(m, chunk)
    for cta in range(plan.ctas):
        base = cta * chunk
        cnt = min(chunk, m - base)
        for p in range(0, cnt, groups * plan.kpt):
            for j in range(plan.kpt):
                for g in range(groups):
                    k = p + j * groups + g
                    if k < cnt:
                        seen[base + k] += 1
    assert (seen == 1).all()


def probe_mirror(tiles, blk, keys, n, plan):
    """The kernel's result, every key's probes as its lane group makes
    them (all keys at once, level by level)."""
    nb, block = tiles.shape
    units = cdiv(block, E)
    m = keys.shape[0]
    b = blk.long().clamp(0, nb - 1)
    lo = torch.zeros(m, dtype=torch.long)
    hi = torch.full((m,), units, dtype=torch.long)
    res = torch.full((m,), -1, dtype=torch.long)
    reads = torch.zeros(m, dtype=torch.long)
    for _ in range(plan.levels):
        live = res < 0
        u = (lo + hi) // 2
        # the group's L lanes: lane r's slice is elements s .. s + 3,
        # s = u * E + 4 r, read only where s < block
        cols = u[:, None] * E + torch.arange(E)[None, :]
        inside_block = cols < block
        assert bool(inside_block[:, 0][live].all())   # a unit of the block
        x = tiles[b[:, None], cols.clamp(max=block - 1)]
        c = ((x <= keys[:, None]) & inside_block).sum(1)
        length = (block - u * E).clamp(max=E)
        reads += live
        hi = torch.where(live & (c == 0), u, hi)
        lo = torch.where(live & (c == length), u + 1, lo)
        res = torch.where(live & (c > 0) & (c < length), u * E + c, res)
        res = torch.where(live & (res < 0) & (lo == hi),
                          (lo * E).clamp(max=block), res)
    assert bool((res >= 0).all()), "a key outlived the plan's levels"
    assert int(reads.max()) <= plan.levels
    return (b * block + res).clamp(max=n).to(torch.int32)


def search_inputs(dtype, n, m, block, seed):
    """A sorted table of n with runs of duplicates, padded with the
    sentinel to whole blocks; keys from the table, between its elements,
    below its first, at its last and at the sentinel; float32 tables
    hold -0.0 and +0.0 among their zeros, and the keys add -0.0, +0.0,
    -inf and inf."""
    rng = np.random.default_rng(seed)
    gaps = rng.integers(0, 4, n)                          # 0: duplicates
    table = np.cumsum(gaps).astype(np.int64) - int(gaps[: n // 2].sum())
    keys = table[rng.integers(0, n, m)] + rng.integers(0, 2, m)
    edges = [table[0] - 1, table[0], table[-1], table[-1] + 1]
    if dtype == np.float32:
        table = table.astype(np.float32)
        zeros = np.flatnonzero(table == 0)
        table[zeros[::2]] = -0.0
        keys = keys.astype(np.float32)
        edges += [-0.0, 0.0, -np.inf, np.inf]
        big = np.float32(np.inf)
    else:
        table, keys = table.astype(np.int32), keys.astype(np.int32)
        edges += [INT_MAX]
        big = INT_MAX
    edges = np.array(edges, dtype)[:m]
    keys[: edges.shape[0]] = edges
    padded = cdiv(n, block) * block
    tiles = np.concatenate([table, np.full(padded - n, big, dtype)])
    return table, keys, tiles.reshape(-1, block)


def block_ids(tiles, keys):
    """ops.py's summary search: the block holding each key's insertion
    point."""
    return (torch.searchsorted(tiles[:, 0].contiguous(), keys, right=True)
            - 1).clamp(0, tiles.shape[0] - 1).to(torch.int32)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("block", [12, 16, 128, 256])
@pytest.mark.parametrize("n,m,chunk,rif", [
    (1001, 300, 64, 64), (700, 97, 24, 3), (130, 1, 64, 1),
    (2048, 1000, 1000, 16),            # chunk over a pass: K = 4
    (50, 33, 8, 4)])                   # one block or less; K = 1
def test_probe_mirror_matches_jax_ref(dtype, block, n, m, chunk, rif):
    table, keys, tiles = search_inputs(dtype, n, m, block, n + m + block)
    want = np.asarray(jax_ref(jnp.asarray(table), jnp.asarray(keys)))
    np.testing.assert_array_equal(
        np.asarray(jd.decoupled_searchsorted(
            jnp.asarray(table), jnp.asarray(keys), block=block, method="ref")),
        want)
    t, k = torch.from_numpy(tiles), torch.from_numpy(keys)
    plan = ck.search_plan(block, m, min(chunk, m), rif)
    walk(m, min(chunk, m), plan)
    got = probe_mirror(t, block_ids(t, k), k, n, plan)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ck.searchsorted_blocks_plain(t, block_ids(t, k),
                                                         k, n))


def test_probe_mirror_at_a_run_of_duplicates_across_units():
    """A run of one value over several units and blocks: every key of
    the run lands after its last copy, whichever unit the search reads
    first."""
    table = np.concatenate([np.arange(40), np.full(300, 40),
                            np.arange(41, 100)]).astype(np.int32)
    keys = np.array([39, 40, 41, 0, 99, 100, -1], np.int32)
    want = np.asarray(jax_ref(jnp.asarray(table), jnp.asarray(keys)))
    n = table.shape[0]
    for block in (16, 128):
        tiles = np.concatenate([table, np.full(cdiv(n, block) * block - n,
                                               INT_MAX, np.int32)])
        t, k = torch.from_numpy(tiles.reshape(-1, block)), \
            torch.from_numpy(keys)
        plan = ck.search_plan(block, keys.shape[0], 64, 16)
        got = probe_mirror(t, block_ids(t, k), k, n, plan)
        np.testing.assert_array_equal(got.numpy(), want)


def test_search_plan():
    """Levels are the bit length of the block's count of 64-byte units (a
    block under one unit is one unit); keys in flight a power of two, at
    most SEARCH_MAX_KPT and no more than a chunk fills; one CTA a
    chunk."""
    p = ck.search_plan(128, 1 << 22, 64, 64)
    assert (p.levels, p.kpt, p.ctas) == (4, ck.SEARCH_MAX_KPT, 65536)
    assert ck.search_plan(4, 10, 64, 16).levels == 1
    assert ck.search_plan(12, 10, 64, 16).levels == 1
    assert ck.search_plan(100, 10, 64, 16).levels == 3     # 7 units
    assert ck.search_plan(256, 10, 64, 16).levels == 5     # 16 units
    assert ck.search_plan(128, 10, 1000, 3).kpt == 2
    assert ck.search_plan(128, 10, 1000, 16).kpt == ck.SEARCH_MAX_KPT
    assert ck.search_plan(128, 10, 8, 16).kpt == 1         # 8 keys, 8 groups
    assert ck.search_plan(128, 10, 9, 16).kpt == 2


def test_cpu_tensors_take_the_plain_version():
    table, keys, tiles = search_inputs(np.int32, 500, 40, 128, 1)
    t, k = torch.from_numpy(tiles), torch.from_numpy(keys)
    before = ck.searchsorted_blocks.launches
    got = ck.searchsorted_blocks(t, block_ids(t, k), k, 500)
    assert ck.searchsorted_blocks.launches == before
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_ref(jnp.asarray(table),
                                        jnp.asarray(keys))))
