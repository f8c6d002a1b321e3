"""Card-only tests of the port's CUDA kernels: each kernel against its
plain PyTorch version, launch counting, input validation, and
smoke-sized serves and forwards through the kernels.

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
from repro_torch.kernels.grouped_matmul import kernel as mk

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
@pytest.mark.parametrize("g,d", [(1, 128), (4, 128), (2, 16), (3, 64),
                                 (5, 64), (8, 64)])
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
                                      (2, 16, 8), (3, 64, 16), (5, 64, 16),
                                      (8, 64, 16)])
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
    with pytest.raises(ValueError):                       # G above 8
        fk.flash_decode(torch.zeros((2, 2, 9, 16), device=cuda), kc, kc,
                        lengths, scale=0.25)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,f,bt,rows", [
    (300, 64, 40, 128, None),           # tail block, F below one tile
    (1152, 96, 200, 128, "dispatch"),   # padding blocks, D not a stage
    (50, 32, 16, 16, None),             # bt below one 128-row slice
    (260, 48, 72, 256, None)])          # bt above one slice
def test_gmm_matches_plain(cuda, dtype, t, d, f, bt, rows):
    gen = torch.Generator(device=cuda).manual_seed(t + d)
    e, nb = 5, -(-t // bt)
    x = torch.randn((t, d), generator=gen, device=cuda).to(dtype)
    w = (torch.randn((e, d, f), generator=gen, device=cuda)
         * d ** -0.5).to(dtype)
    be = torch.randint(0, e, (nb,), generator=gen, device=cuda,
                       dtype=torch.int32)
    block_rows = None
    if rows == "dispatch":           # a few rows, full blocks, empty blocks
        block_rows = torch.randint(0, bt + 1, (nb,), generator=gen,
                                   device=cuda, dtype=torch.int32)
        block_rows[:3] = torch.tensor([1, bt, 0], dtype=torch.int32)
    before = mk.gmm.launches
    got = mk.gmm(x, w, be, bt=bt, block_rows=block_rows)
    assert mk.gmm.launches == before + 1
    _close(got, mk.gmm_plain(x, w, be, bt=bt, block_rows=block_rows), dtype)
    if block_rows is not None:       # rows past the real ones: exact zeros
        r = torch.arange(nb * bt, device=cuda)[:t]
        pad = r % bt >= block_rows[r // bt]
        assert bool((got[pad] == 0).all())


def test_gmm_rejects_bad_inputs(cuda):
    x = torch.zeros((16, 16), device=cuda)
    w = torch.zeros((2, 16, 8), device=cuda)
    be = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                       # block_expert length
        mk.gmm(x, w, be[:1], bt=8)
    with pytest.raises(TypeError):                        # mixed dtypes
        mk.gmm(x.to(torch.bfloat16), w, be, bt=8)
    with pytest.raises(ValueError):                       # F not 16 bytes
        mk.gmm(x, torch.zeros((2, 16, 6), device=cuda), be, bt=8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,h,kvh,s,d", [
    (True, None, 4, 4, 128, 128),
    (True, None, 6, 2, 200, 64),      # GQA, S not a multiple of the block
    (True, 48, 4, 2, 300, 64),        # sliding window
    (False, None, 2, 1, 77, 16),
    (True, None, 3, 3, 1, 32)])
def test_flash_matches_plain(cuda, dtype, causal, window, h, kvh, s, d):
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn((2, h, s, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, kvh, s, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, kvh, s, d), generator=gen, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    before = fk.flash.launches
    got = fk.flash(q, k, v, **kw)
    assert fk.flash.launches == before + 1
    _close(got, fk.attention_plain(q, k, v, **kw), dtype)


def test_flash_rejects_bad_inputs(cuda):
    q = torch.zeros((1, 2, 8, 16), device=cuda)
    with pytest.raises(ValueError):                       # D not instantiated
        fk.flash(torch.zeros((1, 2, 8, 24), device=cuda),
                 torch.zeros((1, 2, 8, 24), device=cuda),
                 torch.zeros((1, 2, 8, 24), device=cuda), causal=True,
                 window=None, scale=0.2)
    with pytest.raises(ValueError):                       # H % KVH != 0
        fk.flash(torch.zeros((1, 3, 8, 16), device=cuda), q, q, causal=True,
                 window=None, scale=0.25)
    with pytest.raises(ValueError):
        fk.flash(q, q, q, causal=True, window=0, scale=0.25)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-4b"])
def test_smoke_prefill_step_through_kernels_matches_plain(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.registry import build_model

    out = {}
    tok = torch.randint(0, 512, (2, 70), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    for mode in ("kernel", "ref"):
        cfg = get_config(arch, smoke=True, kernel_mode=mode)
        params = build_model(cfg).init(
            torch.Generator(device=cuda).manual_seed(0))
        before = fk.flash.launches
        out[mode] = make_prefill_step(cfg)(params, {"tokens": tok})
        assert (fk.flash.launches > before) is (mode == "kernel")
    torch.testing.assert_close(out["kernel"], out["ref"], rtol=0, atol=1e-4)


def test_smoke_serve_through_kernels_matches_plain(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serve_loop import PagedServeLoop, Request

    for arch in ("qwen3-4b", "granite-moe-3b-a800m"):
        out = {}
        for mode in ("kernel", "ref"):
            cfg = get_config(arch, smoke=True, kernel_mode=mode)
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
        assert out["kernel"] == out["ref"], arch
