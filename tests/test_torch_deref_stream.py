"""The indirect hop's stream schedule on the CPU.

``csrc/ring_deref.cu`` runs only on the card.  This file mirrors its
order of work: persistent one-warp CTAs (at most one a chunk), each
walking its chunks (blockIdx.x, + gridDim.x, ...) as one stream of items
in batches of 32.  The index hop banks each batch's rows of b and output
places in a ring of ``rif_a + 1`` batches: the prologue hops the first
``rif_a + 1`` batches, and the hop of batch i + rif_a + 1 is issued
before batch i's rows move and banked in batch i's slot once they are
out.  The warp moves a batch's rows unit by unit (16 or 4 bytes), lane l
taking units l, l + 32, ... of the batch, each unit's row and column
stepped on by 32 units at a time as ``copy_batch`` does.  The mirror
checks the schedule's invariants: the bank holds a row's batch whenever
the row moves, a bank slot is overwritten only once its batch is done,
each unit of each row moves once and every item is written once.  Its
result is held, exactly, to ``jnp`` ``b[clip(a[addrs, 0] + offset, 0,
NB - 1)]`` on numpy inputs (the JAX package's ``ring_deref`` needs
``pl.load``, gone in jax 0.9), and to the port's plain version, which
also clamps addresses outside the index port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.common import cdiv
from repro_torch.kernels.compiled import kernel as rk

WARP = 32
UNROLL = 8                 # ring_deref.cu kUnroll: a lane's units in flight


def copy_batch(b, out_b, rows, items, unit):
    """The warp's copy of one batch: row r of the batch from b[rows[r]]
    to out_b[items[r]], ``unit`` bytes at a time, each lane stepping its
    unit's (row, column) on by 32 units as the kernel does."""
    upr = b.shape[1] * 4 // unit                  # units a row
    per = unit // 4                               # elements a unit
    total = len(rows) * upr
    moved = np.zeros(total, np.int64)
    dr, dc = divmod(WARP, upr)
    for lane in range(WARP):
        r, c = divmod(lane, upr)
        for t0 in range(lane, total, WARP * UNROLL):
            for u in range(UNROLL):
                t = t0 + u * WARP
                if t < total:
                    assert (r, c) == divmod(t, upr)
                    cols = slice(c * per, (c + 1) * per)
                    out_b[items[r], cols] = b[rows[r], cols]
                    moved[t] += 1
                c += dc
                r += dr
                if c >= upr:
                    c -= upr
                    r += 1
    assert (moved == 1).all()


def stream_mirror(a, b, addrs, offset, chunk, rif_a, ctas, unit):
    """(out_a, out_b) as ring_deref.cu's CTAs make them."""
    m, na = addrs.shape[0], a.shape[0]
    nb, wb = b.shape
    n_chunks = cdiv(m, chunk)
    grid = min(ctas, n_chunks)
    depth = rif_a + 1
    span = depth * WARP
    out_a = np.full((m, 1), -99, np.int32)
    out_b = np.full((m, wb), np.nan, np.float32)
    written = np.zeros(m, np.int64)
    for cta in range(grid):
        stream = [c * chunk + k for c in range(cta, n_chunks, grid)
                  for k in range(min(chunk, m - c * chunk))]
        nq = len(stream)
        nbat = cdiv(nq, WARP)
        bank = {}                          # bank place -> (batch, item, row)

        def hop(i):
            for lane in range(WARP):
                q = i * WARP + lane
                if q >= nq:
                    continue
                old = bank.get(q % span)
                assert old is None or old[0] == i - depth   # that batch is done
                it = stream[q]
                va = int(a[min(max(int(addrs[it]), 0), na - 1), 0])
                out_a[it] = va
                bank[q % span] = (i, it, min(max(va + offset, 0), nb - 1))

        for i in range(min(depth, nbat)):  # prologue
            hop(i)
        for i in range(nbat):
            batch = [bank[q % span] for q in
                     range(i * WARP, min(i * WARP + WARP, nq))]
            assert all(bi == i for bi, _, _ in batch)
            items = [it for _, it, _ in batch]
            copy_batch(b, out_b, [row for _, _, row in batch], items, unit)
            written[items] += 1
            if i + depth < nbat:
                hop(i + depth)
    assert (written == 1).all()
    return out_a, out_b


def jax_deref(a, b, addrs, offset):
    """The reference's function in jnp: both loads, the add and the
    clip."""
    va = jnp.asarray(a)[jnp.asarray(addrs), 0]
    vb = jnp.asarray(b)[jnp.clip(va + offset, 0, b.shape[0] - 1)]
    return np.asarray(va)[:, None], np.asarray(vb)


@pytest.mark.parametrize("unit", [16, 4])
@pytest.mark.parametrize("m,chunk,rif_a,ctas", [
    (1, 64, 1, 4224),                  # M = 1
    (20, 64, 2, 4224),                 # M below one batch
    (1000, 64, 1, 7),                  # ragged batches and tail
    (1000, 7, 16, 3),                  # chunks off the batches
    (999, 100, 4, 1000),               # more CTAs than chunks
    (4096, 64, 2, 5)])
@pytest.mark.parametrize("offset", [0, -7, 3])
def test_stream_mirror_matches_jax(unit, m, chunk, rif_a, ctas, offset):
    rng = np.random.default_rng(m * 17 + rif_a)
    na, nb, wb = 300, 200, 4
    a = rng.integers(-40, nb + 40, (na, 1)).astype(np.int32)   # out of range
    b = rng.standard_normal((nb, wb)).astype(np.float32)
    addrs = rng.integers(0, na, m).astype(np.int32)
    want_a, want_b = jax_deref(a, b, addrs, offset)
    got_a, got_b = stream_mirror(a, b, addrs, offset, chunk, rif_a, ctas,
                                 unit)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_b, want_b)
    plain = rk.ring_deref_plain(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(addrs), offset=offset)
    np.testing.assert_array_equal(plain[0].numpy(), want_a)
    np.testing.assert_array_equal(plain[1].numpy(), want_b)


@pytest.mark.parametrize("wb,unit", [
    (1, 4), (3, 4),                    # 4-byte rows and odd widths
    (32, 16), (32, 4),                 # 128-byte rows; an unaligned view
    (100, 16),                         # 25 units a row: steps cross rows
    (40, 4),                           # 40 units a row: more than a warp
    (256, 16)])                        # 64 units a row
@pytest.mark.parametrize("m", [1, 33, 300])
def test_row_walk_matches_jax(wb, unit, m):
    """The warp's unit walk at row widths where a step of 32 units
    crosses rows, stays in one, or needs several to cover one."""
    rng = np.random.default_rng(wb * 31 + m)
    a = rng.integers(0, 90, (60, 1)).astype(np.int32)
    b = rng.standard_normal((90, wb)).astype(np.float32)
    addrs = rng.integers(0, 60, m).astype(np.int32)
    got = stream_mirror(a, b, addrs, 0, 64, 2, 3, unit)
    want = jax_deref(a, b, addrs, 0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_stream_mirror_clamps_addresses_and_adds_in_64_bits():
    """Addresses outside the index port are clamped into it, and
    va + offset past 2^31 clips to the last row instead of wrapping: the
    port's two additions, held to its plain version."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 50, (40, 1)).astype(np.int32)
    a[:3, 0] = [2 ** 31 - 1, -2 ** 31, 49]
    b = rng.standard_normal((50, 3)).astype(np.float32)
    addrs = np.array([-5, 0, 1, 2, 39, 40, 1000] * 10, np.int32)
    for offset in (2 ** 31 - 1, -(2 ** 31), 5):
        got = stream_mirror(a, b, addrs, offset, 16, 1, 3, 4)
        want = rk.ring_deref_plain(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(addrs), offset=offset)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())


def test_cpu_tensors_take_the_plain_version():
    a = torch.tensor([[3], [0], [7]], dtype=torch.int32)
    b = torch.randn((8, 5))
    addrs = torch.tensor([2, 0, 1, 2], dtype=torch.int32)
    before = rk.ring_deref.launches
    got = rk.ring_deref(a, b, addrs, chunk=2, rif_a=1, rif_b=1, offset=-1)
    assert rk.ring_deref.launches == before
    assert torch.equal(got[0], a[addrs.long()])
    assert torch.equal(got[1], b[(a[addrs.long(), 0].long() - 1).clamp(0, 7)])
