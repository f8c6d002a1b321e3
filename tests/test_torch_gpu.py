"""Card-only tests of the port's CUDA kernels: each kernel against its
plain PyTorch version, launch counting, input validation, and a
smoke-sized serve through the kernels.

They carry the ``gpu`` marker and skip without a card.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed; run it there with

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: float32 outputs within 1e-5 (the kernel and the plain
version sum in different orders); bfloat16 outputs within one bf16 ulp
relative plus 1e-3 (both round a float32 result once).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.common import build_kernels
from repro_torch.kernels.dae_gather import kernel as gk
from repro_torch.kernels.flash_attention import kernel as fk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        limit = 1e-3 + 2.0 ** -7 * want.abs()
        assert bool(((got - want).abs() <= limit).all()), \
            float((got - want).abs().max())


def test_build(cuda):
    assert build_kernels() >= 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [13, 200, 2560])
def test_gather_matches_plain(cuda, dtype, d):
    gen = torch.Generator(device=cuda).manual_seed(d)
    n, m = 1000, 300
    table = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    idx = torch.randint(0, n, (m,), generator=gen, device=cuda,
                        dtype=torch.int32)
    idx[:4] = torch.tensor([0, n - 1, 5, 5], dtype=torch.int32)
    before = gk.gather_rows.launches
    got = gk.gather_rows(table, idx)
    assert gk.gather_rows.launches == before + 1
    assert torch.equal(got, gk.gather_rows_plain(table, idx))


def test_gather_rejects_bad_inputs(cuda):
    table = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError):
        gk.gather_rows(table, torch.zeros(3, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        gk.gather_rows(table, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        gk.gather_rows(table.to(torch.int32),
                       torch.zeros(3, dtype=torch.int32, device=cuda))


def _lengths(b, s, bk, gen, dev):
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    fixed = torch.tensor([1, bk, bk + 1, s], dtype=torch.int32)
    lengths[:min(b, 4)] = fixed[:min(b, 4)].to(dev)
    return lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d", [(1, 128), (4, 128), (2, 16)])
def test_decode_contig_matches_plain(cuda, dtype, g, d):
    gen = torch.Generator(device=cuda).manual_seed(g * d)
    b, kvh, s = 5, 3, 300
    q = torch.randn((b, kvh, g, d), generator=gen, device=cuda).to(dtype)
    kc = torch.randn((b, kvh, s, d), generator=gen, device=cuda).to(dtype)
    vc = torch.randn((b, kvh, s, d), generator=gen, device=cuda).to(dtype)
    lengths = _lengths(b, s, fk.DEFAULT_BK, gen, cuda)
    before = fk.flash_decode.launches
    for rif in (None, 1, 3):
        got = fk.flash_decode(q, kc, vc, lengths, scale=d ** -0.5, rif=rif)
        _close(got, fk.decode_plain(q, kc, vc, lengths, scale=d ** -0.5),
               dtype)
    assert fk.flash_decode.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d,page", [(1, 128, 16), (4, 128, 16),
                                      (2, 16, 8)])
def test_decode_paged_matches_plain(cuda, dtype, g, d, page):
    gen = torch.Generator(device=cuda).manual_seed(g * d + page)
    b, kvh, npb = 5, 3, 20
    n_pages = 1 + b * npb
    q = torch.randn((b, kvh, g, d), generator=gen, device=cuda).to(dtype)
    kp = torch.randn((n_pages, kvh, page, d), generator=gen,
                     device=cuda).to(dtype)
    vp = torch.randn((n_pages, kvh, page, d), generator=gen,
                     device=cuda).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=cuda) + 1
    table = perm.to(torch.int32).reshape(b, npb).contiguous()
    lengths = _lengths(b, npb * page, page, gen, cuda)
    before = fk.flash_decode_paged.launches
    got = fk.flash_decode_paged(q, kp, vp, table, lengths, scale=d ** -0.5)
    assert fk.flash_decode_paged.launches == before + 1
    _close(got, fk.decode_paged_plain(q, kp, vp, table, lengths,
                                      scale=d ** -0.5), dtype)


def test_decode_rejects_bad_inputs(cuda):
    q = torch.zeros((2, 2, 2, 16), device=cuda)
    kc = torch.zeros((2, 2, 8, 16), device=cuda)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                       # lengths dtype
        fk.flash_decode(q, kc, kc, lengths.long(), scale=0.25)
    with pytest.raises(TypeError):                        # mixed dtypes
        fk.flash_decode(q, kc.to(torch.bfloat16), kc, lengths, scale=0.25)
    with pytest.raises(ValueError):                       # G not 1/2/4/8
        fk.flash_decode(torch.zeros((2, 2, 3, 16), device=cuda), kc, kc,
                        lengths, scale=0.25)


def test_smoke_serve_through_kernels_matches_plain(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serve_loop import PagedServeLoop, Request

    out = {}
    for mode in ("kernel", "ref"):
        cfg = get_config("qwen3-4b", smoke=True, kernel_mode=mode)
        bundle = build_model(cfg)
        params = bundle.init(torch.Generator(device=cuda).manual_seed(0))
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n),
                        max_new=8) for i, n in enumerate((12, 3, 25, 7))]
        before = fk.flash_decode_paged.launches
        out[mode] = PagedServeLoop(cfg, bundle, params, batch_slots=4,
                                   s_max=40, chunk=16, page=8).run(reqs)
        if mode == "kernel":
            assert fk.flash_decode_paged.launches > before
    assert out["kernel"] == out["ref"]
