"""The port's explicit-ring gather, ``dae_gather(method="rif")``, on the
CPU against the JAX package's ``gather_ref``.

The JAX ``gather_rif`` kernel calls ``pl.load``, which jax 0.9 no longer
has, so it cannot run here in interpret mode; its oracle can.  The same
seeded numpy inputs go through both, over ragged M, chunk 1, 64 and M,
rif 1 and 16, float32 and bfloat16 (an odd width among them).  A gather
copies, so the comparison is exact (bfloat16 compared as float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dae_gather.ref import gather_ref as jax_gather_ref
from repro_torch.core.decouple import decoupled_gather
from repro_torch.core.pipeline import plan_rif
from repro_torch.kernels.dae_gather import kernel as gk
from repro_torch.kernels.dae_gather.ops import dae_gather
from repro_torch.kernels.ring import MAX_RIF


def _inputs(n, d, m, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, m).astype(np.int32)
    if m >= 2:
        idx[:2] = (n - 1, 0)
    return table, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 13, 128])
@pytest.mark.parametrize("m", [1, 100, 257])
@pytest.mark.parametrize("chunk,rif", [(1, 1), (64, 16), (64, 1), ("m", 16)])
def test_rif_gather_matches_jax_ref(dtype, d, m, chunk, rif):
    table, idx = _inputs(300, d, m, seed=d * 1000 + m)
    chunk = m if chunk == "m" else chunk
    want = np.asarray(jax_gather_ref(jnp.asarray(table, dtype),
                                     jnp.asarray(idx)).astype(jnp.float32))
    t = torch.from_numpy(table).to(getattr(torch, dtype))
    before = gk.gather_rif.launches
    got = dae_gather(t, torch.from_numpy(idx), method="rif", chunk=chunk,
                     rif=rif)
    assert got.dtype == t.dtype and got.shape == (m, d)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert gk.gather_rif.launches == before          # the CPU launches nothing


def test_rif_knobs_resolve_explicit_then_plan_rif(monkeypatch):
    """rif left None is plan_rif over one chunk of rows (the reference's
    sizing), clamped to MAX_RIF and to the chunk; M = 0 gives (0, D)."""
    seen = {}

    def spy(table, idx, *, chunk, rif):
        seen.update(chunk=chunk, rif=rif)
        return gk.gather_rif_plain(table, idx)

    monkeypatch.setattr(gk, "gather_rif", spy)
    table, idx = _inputs(50, 8, 40, seed=1)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    dae_gather(t, i, method="rif")
    want = min(plan_rif(64 * 8 * 4).rif, MAX_RIF, 40)
    assert seen == {"chunk": 40, "rif": want}
    dae_gather(t, i, method="rif", chunk=8, rif=64)
    assert seen == {"chunk": 8, "rif": 8}
    dae_gather(t, i, method="rif", chunk=64, rif=40)
    assert seen == {"chunk": 40, "rif": MAX_RIF}
    empty = dae_gather(t, i[:0], method="rif")
    assert empty.shape == (0, 8)


def test_decoupled_gather_is_dae_gather():
    table, idx = _inputs(64, 5, 33, seed=2)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    assert decoupled_gather is dae_gather
    for method in ("pipelined", "rif", "ref"):
        np.testing.assert_array_equal(
            decoupled_gather(t, i, method=method).numpy(), table[idx])
    with pytest.raises(ValueError, match="unknown method"):
        decoupled_gather(t, i, method="kernel")
    with pytest.raises(ValueError, match="chunk"):
        decoupled_gather(t, i, method="rif", chunk=0)


def test_plain_version_clamps_like_the_kernel():
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    idx = torch.tensor([-3, 0, 5, 9], dtype=torch.int32)
    np.testing.assert_array_equal(gk.gather_rif_plain(table, idx).numpy(),
                                  table.numpy()[[0, 0, 5, 5]])
