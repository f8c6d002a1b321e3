"""The explicit-ring gather's bulk schedule on the CPU.

``csrc/ring_gather.cu``'s bulk body runs only on the card.  This file
mirrors its order of work: ``ctas`` CTAs (or one a chunk), each walking
its chunks (blockIdx.x, + gridDim.x, ...) as one stream of rows, its one
thread issuing every copy through ring slots q % rif: a prologue that
requests the first rif rows, then for each row: wait for its slot, copy
the slot out, and once that copy has read the slot, refill it with the
row rif further on.  The mirror checks the schedule's invariants (a
slot is refilled only once it is free, it holds the row that is copied
out of it, every row is written once) and its result against the JAX
package's ``gather_ref`` (its ``gather_rif`` kernel needs ``pl.load``,
gone in jax 0.9).  A gather copies, so the comparison is exact.  Then
the wrapper's choice of body and of CTA count, from the rows' alignment
and the ring's size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dae_gather.ref import gather_ref as jax_gather_ref
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.dae_gather import kernel as gk


def bulk_mirror(table, idx, chunk, rif, ctas):
    """The bulk body's result, row by row as its CTAs would move it."""
    n, m = table.shape[0], idx.shape[0]
    n_chunks = cdiv(m, chunk)
    grid = ctas if 0 < ctas < n_chunks else n_chunks
    out = np.full((m, table.shape[1]), np.nan, table.dtype)
    written = np.zeros(m, np.int64)
    for cta in range(grid):
        # the CTA's stream: its chunks' rows, chunk after chunk
        stream = [c * chunk + k for c in range(cta, n_chunks, grid)
                  for k in range(min(chunk, m - c * chunk))]
        slots = {}                                  # slot -> stream row

        def request(q):
            assert q % rif not in slots              # the slot is free
            slots[q % rif] = q

        for q in range(min(rif, len(stream))):      # prologue
            request(q)
        for q in range(len(stream)):
            assert slots[q % rif] == q               # the row has landed
            row = stream[q]
            out[row] = table[min(max(int(idx[row]), 0), n - 1)]
            written[row] += 1
            del slots[q % rif]                       # the copy has read it
            if q + rif < len(stream):
                request(q + rif)
        assert not slots
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,chunk", [(1, 64), (300, 64), (257, 100),
                                     (130, 1)])
@pytest.mark.parametrize("rif,ctas", [(1, 0), (2, 0), (2, 3), (4, 2),
                                      (16, 0), (6, 5)])
def test_bulk_schedule_matches_jax_ref(dtype, m, chunk, rif, ctas):
    rng = np.random.default_rng(m * 31 + rif)
    table = rng.standard_normal((97, 8)).astype(np.float32)
    idx = rng.integers(0, 97, m).astype(np.int32)
    idx[0] = 96
    want = np.asarray(jax_gather_ref(jnp.asarray(table, dtype),
                                     jnp.asarray(idx)).astype(jnp.float32))
    t = torch.from_numpy(table).to(getattr(torch, dtype)).float().numpy()
    got = bulk_mirror(t, idx, chunk, rif, ctas)
    np.testing.assert_array_equal(got, want)


def test_bulk_body_needs_aligned_rows():
    """Rows and base pointers that are 16-byte multiples move as bulk
    copies; a 4-byte row, an odd bf16 width or a base off 16 bytes keep
    the register body."""
    t = torch.zeros((10, 2560))
    assert gk.bulk_rows(t, t)
    assert not gk.bulk_rows(torch.zeros((10, 1)), t)
    assert not gk.bulk_rows(torch.zeros((10, 13), dtype=torch.bfloat16), t)
    flat = torch.zeros(10 * 256 + 4)
    off = flat[1:1 + 10 * 256].view(10, 256)
    assert not gk.bulk_rows(off, t)


def test_bulk_cta_count():
    """Rings of 16 KiB or more (10 KB rows, rif 2) run two persistent CTAs
    an SM where two fit; small rings (128-byte rows, rif 16) and rings too
    large for two an SM keep one CTA a chunk."""
    smem = 232_448
    assert gk.bulk_ctas(2 * 10240, 1024, 132, smem) == 264
    assert gk.bulk_ctas(2 * 10240, 100, 132, smem) == 100
    assert gk.bulk_ctas(16 * 128, 65536, 132, smem) == 0
    assert gk.bulk_ctas(16 * 10240, 1024, 132, smem) == 0


def test_cpu_tensors_take_the_plain_version():
    table = torch.randn((50, 2560))
    idx = torch.tensor([49, 0, 7, 7], dtype=torch.int32)
    before = gk.gather_rif.launches
    got = gk.gather_rif(table, idx, chunk=2, rif=2)
    assert gk.gather_rif.launches == before
    assert torch.equal(got, table[idx.long()])
