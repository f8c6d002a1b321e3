"""The embedding gather's item grid on the CPU.

``csrc/dae_gather.cu`` runs only on the card.  This file mirrors its
work in numpy: ``gather_plan`` cuts each row into items of at most
``SLICE_UNITS`` units (16-byte vectors, 4-byte words or 2-byte elements,
the widest the row size and both base pointers allow: ``row_unit``);
CTA c walks items c, c + ctas, ...; in an item, each of the CTA's 256
threads moves units t, t + 256, t + 512, t + 768 of the slice, all
loaded before any is stored.  The mirror checks that every output unit
is written exactly once, and its result against JAX's
``gather_pipelined`` in interpret mode (one ``(1, D)`` block a grid
step).  A gather copies, so the comparison is exact, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dae_gather.kernel import gather_pipelined
from repro_torch.kernels.dae_gather import kernel as gk

THREADS, UNROLL = 256, 4        # dae_gather.cu's kThreads, kUnroll


def gather_mirror(table_bytes, idx, unit):
    """dae_gather.cu's result: ``table_bytes`` (N, row bytes) uint8."""
    n, row_bytes = table_bytes.shape
    m = idx.shape[0]
    units = row_bytes // unit
    rows = table_bytes.reshape(n, units, unit)
    slices, ctas = gk.gather_plan(m, units)
    assert slices * gk.SLICE_UNITS >= units
    out = np.zeros((m, units, unit), np.uint8)
    written = np.zeros((m, units), np.int64)
    lane = (np.arange(THREADS)[:, None]
            + THREADS * np.arange(UNROLL)[None, :]).reshape(-1)
    assert THREADS * UNROLL == gk.SLICE_UNITS
    for cta in range(ctas):
        for it in range(cta, m * slices, ctas):
            i, s = divmod(it, slices)
            c0 = s * gk.SLICE_UNITS
            c = c0 + lane[c0 + lane < min(c0 + gk.SLICE_UNITS, units)]
            r = min(max(int(idx[i]), 0), n - 1)
            loaded = rows[r, c]                  # every load of the item
            out[i, c] = loaded                   # then every store
            written[i, c] += 1
    assert (written == 1).all()
    return out.reshape(m, row_bytes)


def _as_bytes(x):
    return np.ascontiguousarray(x).view(np.uint8).reshape(x.shape[0], -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [13, 200, 1536, 2560])
@pytest.mark.parametrize("m", [1, 8, 257])
def test_item_grid_matches_jax(dtype, d, m):
    rng = np.random.default_rng(d * 1000 + m)
    n = 300
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, m).astype(np.int32)
    idx[0] = n - 1
    jt = jnp.asarray(table, dtype)
    want = np.asarray(gather_pipelined(jt, jnp.asarray(idx), block_d=d,
                                       interpret=True))
    host = np.asarray(jt)                        # the table's own bits
    unit = gk.row_unit(host.shape[1] * host.itemsize, 0, 0)
    got = gather_mirror(_as_bytes(host), idx, unit)
    np.testing.assert_array_equal(got, _as_bytes(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_item_grid_at_4096_rows_matches_jax(dtype):
    """granite's make_prefill_step gathers 4096 rows; JAX's interpret
    mode walks one grid step a row, so the rows are narrow here."""
    rng = np.random.default_rng(4096)
    n, d, m = 1000, 16, 4096
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, m).astype(np.int32)
    jt = jnp.asarray(table, dtype)
    want = np.asarray(gather_pipelined(jt, jnp.asarray(idx), block_d=d,
                                       interpret=True))
    host = np.asarray(jt)
    unit = gk.row_unit(host.shape[1] * host.itemsize, 0, 0)
    got = gather_mirror(_as_bytes(host), idx, unit)
    np.testing.assert_array_equal(got, _as_bytes(want))


def test_unit_is_the_widest_the_rows_allow():
    """16-byte vectors where the row size and both bases allow them;
    4-byte words for odd f32 widths and bases off 16 bytes; 2-byte
    elements for odd bf16 widths and bases off 4 bytes."""
    assert gk.row_unit(2560 * 4, 0, 512) == 16
    assert gk.row_unit(13 * 4, 0, 512) == 4
    assert gk.row_unit(1536 * 4, 4, 512) == 4
    assert gk.row_unit(13 * 2, 0, 512) == 2
    assert gk.row_unit(200 * 2, 2, 512) == 2


@pytest.mark.parametrize("m,units,slices", [(8, 640, 1), (256, 384, 1),
                                            (4096, 384, 1), (8, 1024, 1),
                                            (8, 2048, 2), (3, 2049, 3)])
def test_plan_keeps_rows_whole_up_to_a_slice(m, units, slices):
    """Both models' embedding rows (10 KB and 6 KB of f32, 640 and 384
    vectors) are one item each; wider rows are cut into slices of at
    most SLICE_UNITS units, every item walked by one CTA."""
    got_slices, ctas = gk.gather_plan(m, units)
    assert got_slices == slices
    assert ctas == min(m * slices, gk.MAX_GRID)


def test_mirror_wide_rows_written_once():
    """Rows of 2049 16-byte vectors (three slices, the last one unit)."""
    rng = np.random.default_rng(7)
    table = rng.integers(0, 255, (5, 2049 * 16)).astype(np.uint8)
    idx = np.array([4, 0, 2], np.int32)
    got = gather_mirror(table, idx, 16)
    np.testing.assert_array_equal(got, table[idx])


def test_cpu_tensors_take_the_plain_version():
    table = torch.randn((50, 2560))
    idx = torch.tensor([49, 0, 7, 7], dtype=torch.int32)
    before = gk.gather_rows.launches
    got = gk.gather_rows(table, idx)
    assert gk.gather_rows.launches == before
    assert torch.equal(got, table[idx.long()])
