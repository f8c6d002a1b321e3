"""Parity of the port's kernel modules with the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function
(its Pallas kernel in interpret mode, or its ``ref`` method) and the
port's counterpart (on CPU tensors a port wrapper runs its kernel's
plain version).  float32 throughout, tolerance 1e-5: both sides sum in
float32 in different orders.  The CUDA kernels themselves are held
against these plain versions on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipeline import plan_rif as jax_plan_rif
from repro.kernels.dae_gather import dae_gather as jax_dae_gather
from repro.kernels.flash_attention.ops import flash_decode as jax_decode
from repro.kernels.flash_attention.ops import \
    flash_decode_paged as jax_decode_paged
from repro.kernels.ring import clamp_rif as jax_clamp_rif
from repro_torch.core.pipeline import plan_rif
from repro_torch.kernels.common import cdiv, env_flag, round_up
from repro_torch.kernels.dae_gather import dae_gather
from repro_torch.kernels.dae_gather import kernel as gk
from repro_torch.kernels.flash_attention import (decode_chunk_ref,
                                                 flash_decode,
                                                 flash_decode_paged)
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.ring import clamp_rif

ATOL = 1e-5
# JAX method -> the port's: "pallas" runs the kernel there, and here the
# kernel wrapper's plain version (CPU tensors)
METHODS = [("pallas", "kernel"), ("ref", "ref")]
PAGE = 8


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("d", [200, 128])
@pytest.mark.parametrize("jax_method,method", [("pipelined", "pipelined"),
                                               ("ref", "ref")])
def test_gather_matches_jax(d, jax_method, method):
    rng = np.random.default_rng(d)
    n = 50
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, 37).astype(np.int32)
    idx[:4] = [0, n - 1, 3, 3]                      # ends and a repeat
    want = np.asarray(jax_dae_gather(jnp.asarray(table), jnp.asarray(idx),
                                     method=jax_method, interpret=True))
    got = dae_gather(_t(table), _t(idx), method=method).numpy()
    assert got.shape == (37, d)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _decode_inputs(g, seed, s):
    rng = np.random.default_rng(seed)
    b, kvh, d = 4, 2, 16
    q = rng.standard_normal((b, kvh * g, d)).astype(np.float32)
    kc = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    vc = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    lengths = np.array([1, PAGE, PAGE + 1, s], np.int32)
    return q, kc, vc, lengths


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("jax_method,method", METHODS)
def test_flash_decode_matches_jax(g, jax_method, method):
    s = 3 * PAGE
    q, kc, vc, lengths = _decode_inputs(g, g, s)
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths), bk=PAGE, rif=2, method=jax_method,
        interpret=True))
    got = flash_decode(_t(q), _t(kc), _t(vc), _t(lengths), bk=PAGE,
                       method=method).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("jax_method,method", METHODS)
def test_flash_decode_paged_matches_jax(g, jax_method, method):
    npb = 3
    q, _, _, lengths = _decode_inputs(g, 10 + g, npb * PAGE)
    rng = np.random.default_rng(20 + g)
    b, kvh, d = 4, 2, 16
    n_pages = 1 + b * npb
    kp = rng.standard_normal((n_pages, kvh, PAGE, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, kvh, PAGE, d)).astype(np.float32)
    table = (rng.permutation(n_pages - 1) + 1).astype(np.int32)
    table = table.reshape(b, npb)
    want = np.asarray(jax_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), rif=2, method=jax_method, interpret=True))
    got = flash_decode_paged(_t(q), _t(kp), _t(vp), _t(table), _t(lengths),
                             method=method).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_decode_chunk_ref_matches_stepwise_bit_for_bit():
    """Chunked prefill must equal single-token decode steps exactly."""
    q, kc, vc, _ = _decode_inputs(2, 5, 3 * PAGE)
    qc = _t(np.stack([q, q[::-1].copy()], axis=2))            # (B,H,2,D)
    lens = torch.tensor([[1, 2], [8, 9], [9, 10], [20, 24]], dtype=torch.int32)
    chunk = decode_chunk_ref(qc, _t(kc), _t(vc), lens)
    for i in range(2):
        step = flash_decode(qc[:, :, i].contiguous(), _t(kc), _t(vc),
                            lens[:, i], method="ref")
        assert torch.equal(chunk[:, :, i], step)


@pytest.mark.parametrize("block_bytes", [1, 512, 4096, 8192, 65536, 10**6])
def test_plan_rif_keeps_the_jax_rule(block_bytes):
    kw = dict(latency_s=1e-6, bandwidth=3.35e12)
    mine = plan_rif(block_bytes, smem_budget=116_224, **kw)
    ref = jax_plan_rif(block_bytes, vmem_budget=116_224, **kw)
    assert (mine.rif, mine.block_bytes, mine.inflight_bytes) == \
        (ref.rif, ref.block_bytes, ref.inflight_bytes)
    assert mine.smem_fraction == pytest.approx(ref.vmem_fraction)
    assert mine.note == ref.note.replace("vmem", "smem")


def test_plan_rif_defaults_fit_the_card():
    """Default budget: half of the 227 KB a block may opt into."""
    plan = plan_rif(16 * 128 * 2)                   # one bf16 page block
    assert plan.note == "smem-bound" and plan.rif == 116_224 // 4096
    assert plan.inflight_bytes <= 116_224


@pytest.mark.parametrize("rif,n", [(0, 5), (1, 5), (4, 5), (8, 5), (3, 0),
                                   (64, 1)])
def test_clamp_rif_matches_jax(rif, n):
    assert clamp_rif(rif, n) == jax_clamp_rif(rif, n)


def test_int_helpers(monkeypatch):
    assert (cdiv(7, 2), round_up(7, 4), cdiv(8, 4)) == (4, 8, 2)
    monkeypatch.delenv("REPRO_TORCH_FLAG", raising=False)
    assert env_flag("REPRO_TORCH_FLAG") is None
    for raw, want in (("0", False), ("off", False), ("", False), ("1", True),
                      ("yes", True)):
        monkeypatch.setenv("REPRO_TORCH_FLAG", raw)
        assert env_flag("REPRO_TORCH_FLAG") is want


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    counts = (gk.gather_rows.launches, fk.flash_decode.launches,
              fk.flash_decode_paged.launches)
    q, kc, vc, lengths = _decode_inputs(2, 3, 2 * PAGE)
    flash_decode(_t(q), _t(kc), _t(vc), _t(lengths))
    table = torch.arange(8, dtype=torch.int32).reshape(4, 2)
    flash_decode_paged(_t(q), _t(kc).reshape(8, 2, PAGE, 16),
                       _t(vc).reshape(8, 2, PAGE, 16), table, _t(lengths))
    dae_gather(torch.zeros(5, 3), torch.tensor([1, 2], dtype=torch.int32))
    assert (gk.gather_rows.launches, fk.flash_decode.launches,
            fk.flash_decode_paged.launches) == counts


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    """A tensor that is not on the CPU must launch the kernel or raise;
    here a meta tensor (neither CPU nor CUDA) must raise."""
    table = torch.zeros(5, 3, device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        gk.gather_rows(table, idx)
    q = torch.zeros(2, 2, 2, 16, device="meta")
    kc = torch.zeros(2, 2, 8, 16, device="meta")
    lengths = torch.ones(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        fk.flash_decode(q, kc, kc, lengths, scale=0.25)
    with pytest.raises(ValueError):
        fk.flash_decode_paged(q, kc, kc, torch.zeros(
            2, 1, dtype=torch.int32, device="meta"), lengths, scale=0.25)


def test_unknown_methods_raise():
    with pytest.raises(ValueError):
        dae_gather(torch.zeros(2, 2), torch.zeros(1, dtype=torch.int32),
                   method="bogus")
    with pytest.raises(ValueError):           # gather_rif is not ported
        dae_gather(torch.zeros(2, 2), torch.zeros(1, dtype=torch.int32),
                   method="rif")
    with pytest.raises(ValueError):
        flash_decode(torch.zeros(1, 2, 16), torch.zeros(1, 1, 8, 16),
                     torch.zeros(1, 1, 8, 16), torch.ones(1), method="pallas")
