"""Card-only tests of the port's CUDA kernels: each kernel against its
plain PyTorch version, launch counting, input validation, and
smoke-sized serves and forwards through the kernels.

They carry the ``gpu`` marker and skip without a card.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed; run it there with

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: float32 outputs within 1e-5 (the kernel and the plain
version sum in different orders); bfloat16 outputs within one bf16 ulp
relative plus 1e-3 (both round a float32 result once).  The irregular
kernels (searchsorted, hash walk, merge) are exact; the SpMV is held
within 1e-5 times the largest row sum of |val * vec|.  The explicit-ring
gather, the compiler's three ring kernels and the compiled targets are
exact (copies and int32 arithmetic).
"""

import numpy as np
import pytest
import torch

from repro_torch.compile import CompileError
from repro_torch.compile import chase as cops
from repro_torch.compile.targets import (COMPILE_TARGETS, assert_parity,
                                         compile_target)
from repro_torch.core import decouple as dec
from repro_torch.kernels.common import build_kernels
from repro_torch.kernels.compiled import kernel as rk
from repro_torch.kernels.dae_chase import kernel as ck
from repro_torch.kernels.dae_gather import kernel as gk
from repro_torch.kernels.dae_merge import kernel as mgk
from repro_torch.kernels.dae_merge.ops import merge_path_splits
from repro_torch.kernels.dae_spmv import kernel as sk
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


# ---------------------------------------------------------------------------
# the paper's irregular kernels
# ---------------------------------------------------------------------------


def _sorted_table(n, dtype, gen, dev):
    gaps = torch.randint(0, 4, (n,), generator=gen, device=dev,
                         dtype=torch.int32)            # 0: duplicates
    return torch.cumsum(gaps, 0, dtype=torch.int32).to(dtype)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("n,m,block,chunk,rif", [
    (5000, 1000, 128, 64, None),
    (5000, 1000, 128, 24, 1),          # chunk does not divide M; rif 1
    (100_000, 3001, 128, 64, 16),      # the deepest ring
    (300, 77, 16, 1000, 3),            # one CTA, chunk > M
    (128, 50, 128, 7, 2)])
def test_searchsorted_blocks_matches_plain(cuda, dtype, n, m, block, chunk,
                                           rif):
    gen = torch.Generator(device=cuda).manual_seed(n + m)
    table = _sorted_table(n, dtype, gen, cuda)
    keys = table[torch.randint(0, n, (m,), generator=gen, device=cuda)]
    keys[:3] = torch.tensor([-1, 0, 10 ** 6], device=cuda).to(dtype)
    padded = -(-n // block) * block
    big = float("inf") if dtype == torch.float32 else 2 ** 31 - 1
    tiles = torch.cat([table, table.new_full((padded - n,), big)]
                      ).reshape(-1, block)
    blk = (torch.searchsorted(tiles[:, 0].contiguous(), keys, right=True)
           - 1).clamp(0, tiles.shape[0] - 1).to(torch.int32)
    before = ck.searchsorted_blocks.launches
    got = ck.searchsorted_blocks(tiles, blk, keys, n, chunk=chunk, rif=rif)
    assert ck.searchsorted_blocks.launches == before + 1
    assert torch.equal(got, ck.searchsorted_blocks_plain(tiles, blk, keys, n))
    assert torch.equal(got, torch.searchsorted(table, keys, right=True)
                       .to(torch.int32))
    assert torch.equal(dec.decoupled_searchsorted(table, keys), got)


@pytest.mark.parametrize("chunk", [64, 1000, 1])
def test_hash_probe_matches_plain(cuda, chunk):
    """Chains of 16 placed by a permutation, misses, dead heads and a
    pointer past the table."""
    gen = torch.Generator(device=cuda).manual_seed(chunk)
    n, chain, m = 1 << 14, 16, 5000
    slot = torch.randperm(n, generator=gen, device=cuda)
    e = torch.arange(n, device=cuda)
    ek = torch.empty(n, dtype=torch.int32, device=cuda)
    ev = torch.empty_like(ek)
    en = torch.empty_like(ek)
    ek[slot] = (e * 3 + 1).to(torch.int32)
    ev[slot] = torch.randint(0, 2 ** 30, (n,), generator=gen, device=cuda,
                             dtype=torch.int32)
    en[slot] = torch.where(e % chain == chain - 1, -1,
                           slot[(e + 1).clamp(max=n - 1)]).to(torch.int32)
    en[slot[5]] = n + 3
    c = torch.randint(0, n // chain, (m,), generator=gen, device=cuda)
    d = torch.randint(0, chain, (m,), generator=gen, device=cuda)
    heads = slot[c * chain].to(torch.int32)
    keys = ek[slot[c * chain + d]]
    keys[::8] = -2                                   # misses
    heads[1::97] = -1                                # dead heads
    heads[:4] = slot[0].to(torch.int32)              # through slot[5]'s pointer
    packed = torch.stack([ek, ev, en, torch.zeros_like(ek)], 1).contiguous()
    before = ck.hash_probe.launches
    got = ck.hash_probe(packed, heads, keys, max_steps=chain, chunk=chunk)
    assert ck.hash_probe.launches == before + 1
    assert torch.equal(got, ck.hash_probe_plain(packed, heads, keys,
                                                max_steps=chain))
    hits = (keys != -2) & (heads >= 0) & (c != 0)  # chain 0 has the bad pointer
    hits[:4] = False
    assert torch.equal(got[hits], ev[slot[c * chain + d]][hits])


@pytest.mark.parametrize("bm,bk,rif", [(8, 128, None), (8, 128, 1),
                                       (8, 128, 16), (4, 64, 2),
                                       (32, 32, 3)])
def test_bsr_spmv_matches_plain(cuda, bm, bk, rif):
    """Random blocks, row_ids sorted as the kernel requires, and every
    50th block row empty."""
    gen = torch.Generator(device=cuda).manual_seed(bm * bk)
    nrb, kb, nb = 300, 97, 2000
    row_ids = torch.sort(torch.randint(0, nrb, (nb,), generator=gen,
                                       device=cuda)).values
    row_ids = row_ids[(row_ids % 50) != 7].to(torch.int32)  # empty rows
    nb = row_ids.shape[0]
    col_ids = torch.randint(0, kb, (nb,), generator=gen, device=cuda,
                            dtype=torch.int32)
    val = torch.randn((nb, bm, bk), generator=gen, device=cuda)
    vec = torch.randn((kb, bk), generator=gen, device=cuda)
    before = sk.bsr_spmv.launches
    got = sk.bsr_spmv(val, row_ids, col_ids, vec, nrb, rif=rif)
    assert sk.bsr_spmv.launches == before + 1
    want = sk.bsr_spmv_plain(val, row_ids, col_ids, vec, nrb)
    sums = sk.bsr_spmv_plain(val.abs(), row_ids, col_ids, vec.abs(), nrb)
    assert float((got - want).abs().max()) <= 1e-5 * float(sums.max())
    assert bool((got[7::50] == 0).all())


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("n,m,tile,rif", [
    (1001, 333, 256, None),     # windows at unaligned element offsets
    (1001, 333, 256, 1),
    (50_000, 70_001, 128, 16),
    (0, 500, 64, 2),            # an empty run
    (7, 3, 2, 1),               # the smallest tile
    (4096, 4096, 1024, 4)])     # the largest tile
def test_merge_tiles_matches_plain(cuda, dtype, n, m, tile, rif):
    gen = torch.Generator(device=cuda).manual_seed(n + m + tile)
    a = torch.sort(torch.randint(0, 500, (n,), generator=gen, device=cuda)
                   ).values.to(dtype)
    b = torch.sort(torch.randint(0, 500, (m,), generator=gen, device=cuda)
                   ).values.to(dtype)
    n_tiles = -(-(n + m) // tile)
    ia, ib = merge_path_splits(a, b, tile, n_tiles)
    ea, eb = torch.full_like(ia, n), torch.full_like(ib, m)
    before = mgk.merge_tiles.launches
    got = mgk.merge_tiles(a, b, ia, ea, ib, eb, n + m, tile=tile, rif=rif)
    assert mgk.merge_tiles.launches == before + 1
    assert torch.equal(got, mgk.merge_tiles_plain(a, b, ia, ea, ib, eb,
                                                  n + m, tile=tile))
    assert torch.equal(got, torch.sort(torch.cat([a, b])).values)


@pytest.mark.parametrize("n,tile", [(1 << 16, 256), (100_003, 128), (5, 64)])
def test_merge_sort_launches_once_per_pass(cuda, n, tile):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                      device=cuda, dtype=torch.int32)
    before = mgk.merge_tiles.launches
    got = dec.decoupled_merge_sort(x, tile=tile)
    passes = max(0, (-(-n // tile) - 1).bit_length())
    assert mgk.merge_tiles.launches == before + passes
    assert torch.equal(got, torch.sort(x).values)


def test_irregular_kernels_raise_on_bad_cuda_inputs(cuda):
    """CUDA tensors never fall back to the plain versions: what a kernel
    does not take raises."""
    i32 = dict(dtype=torch.int32, device=cuda)
    tiles = torch.zeros((4, 128), **i32)
    with pytest.raises(TypeError):                        # int64 table
        ck.searchsorted_blocks(tiles.long(), torch.zeros(3, **i32),
                               torch.zeros(3, dtype=torch.int64,
                                           device=cuda), 500)
    with pytest.raises(ValueError):                       # keys on the CPU
        ck.searchsorted_blocks(tiles, torch.zeros(3, **i32),
                               torch.zeros(3, dtype=torch.int32), 500)
    with pytest.raises(ValueError):                       # chunk too large
        ck.searchsorted_blocks(tiles, torch.zeros(3, **i32),
                               torch.zeros(3, **i32), 500, chunk=4096)
    with pytest.raises(ValueError):                       # 3-word entries
        ck.hash_probe(torch.zeros((8, 3), **i32), torch.zeros(2, **i32),
                      torch.zeros(2, **i32), max_steps=2)
    with pytest.raises(TypeError):                        # float64 blocks
        sk.bsr_spmv(torch.zeros((1, 8, 128), dtype=torch.float64,
                                device=cuda), torch.zeros(1, **i32),
                    torch.zeros(1, **i32),
                    torch.zeros((1, 128), dtype=torch.float64, device=cuda),
                    1)
    with pytest.raises(ValueError):                       # tile not 2^k
        mgk.merge_tiles(torch.zeros(8, **i32), torch.zeros(8, **i32),
                        *(torch.zeros(1, **i32) for _ in range(4)), 6,
                        tile=6)


# ---------------------------------------------------------------------------
# the explicit-ring gather and the compiler's ring kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,d", [(torch.float32, 1), (torch.float32, 3),
                                     (torch.float32, 32),
                                     (torch.float32, 2560),
                                     (torch.bfloat16, 13),
                                     (torch.float16, 128),
                                     (torch.bfloat16, 1)])
@pytest.mark.parametrize("m,chunk,rif", [(0, 64, 8), (1, 64, 16),
                                         (100, 64, 16), (100, 1, 1),
                                         (257, 100, 1)])
def test_gather_rif_matches_plain(cuda, dtype, d, m, chunk, rif):
    gen = torch.Generator(device=cuda).manual_seed(d + m)
    n = 1000
    table = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    idx = torch.randint(0, n, (m,), generator=gen, device=cuda,
                        dtype=torch.int32)
    before = gk.gather_rif.launches
    got = dec.decoupled_gather(table, idx, method="rif", chunk=chunk,
                               rif=rif)
    torch.cuda.synchronize()
    assert torch.equal(got, gk.gather_rif_plain(table, idx))
    assert gk.gather_rif.launches == before + (1 if m else 0)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("w", [1, 3, 32, 128])
@pytest.mark.parametrize("m,chunk,rif", [(0, 64, 16), (70, 64, 16),
                                         (129, 16, 1), (64, 64, 9)])
def test_ring_gather_matches_plain(cuda, dtype, w, m, chunk, rif):
    gen = torch.Generator(device=cuda).manual_seed(w + m)
    n = 777
    port = (torch.randn((n, w), generator=gen, device=cuda) * 1000
            ).to(dtype)
    addrs = torch.randint(0, n, (m,), generator=gen, device=cuda,
                          dtype=torch.int32)
    if m:
        addrs[0] = n - 1
    before = rk.ring_gather.launches
    got = rk.ring_gather(port, addrs, chunk=chunk, rif=rif)
    torch.cuda.synchronize()
    assert got.shape == (m, w)
    assert torch.equal(got, rk.ring_gather_plain(port, addrs))
    assert rk.ring_gather.launches == before + (1 if m else 0)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("wb", [1, 3, 32, 128])
@pytest.mark.parametrize("m,chunk,rif_a,rif_b,offset", [
    (0, 64, 16, 16, 0), (100, 64, 16, 16, 0), (100, 64, 1, 1, 3),
    (333, 40, 5, 16, -7)])
def test_ring_deref_matches_plain(cuda, dtype, wb, m, chunk, rif_a, rif_b,
                                  offset):
    """Index values below 0 and past NB (clipped) among the valid ones."""
    gen = torch.Generator(device=cuda).manual_seed(wb + m)
    na, nb = 500, 300
    a = torch.randint(-50, nb + 50, (na, 1), generator=gen, device=cuda,
                      dtype=torch.int32)
    b = (torch.randn((nb, wb), generator=gen, device=cuda) * 1000).to(dtype)
    addrs = torch.randint(0, na, (m,), generator=gen, device=cuda,
                          dtype=torch.int32)
    before = rk.ring_deref.launches
    got_a, got_b = rk.ring_deref(a, b, addrs, chunk=chunk, rif_a=rif_a,
                                 rif_b=rif_b, offset=offset)
    want_a, want_b = rk.ring_deref_plain(a, b, addrs, offset=offset)
    torch.cuda.synchronize()
    assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)
    assert rk.ring_deref.launches == before + (1 if m else 0)


def _wide_spec():
    """S = 8, W = 8: every op the tracer knows, with wrapping products."""
    def addr_fn(s):
        return cops.clip(s[0] * 7919 + s[1] // 3 - s[2] % 5, 0, 1 << 20)

    def step_fn(s, row):
        a = s[0] + row[0] * row[1]
        b = cops.where(row[2] < row[3], s[1] - row[4], s[1] ^ row[5])
        c = cops.maximum(s[2] | row[6], cops.minimum(s[3], -row[7]))
        d = s[3] * 1_000_003 + (~s[4])
        e = (s[4] // (row[0] % 7 - 8)) + (s[5] % (row[1] % 5 + 1))
        f = cops.where(~(s[6] >= row[2]) & (s[7] != 0), s[6] + 1, s[6] - 1)
        return (a, b, c, d, e, f, s[7] + (row[3] == row[4]), -s[5])

    def out_fn(s):
        return s[0] % 1000, s[1] + s[2] + s[3] + s[4] + s[5] + s[6] + s[7]

    return addr_fn, step_fn, out_fn


def _floor_spec():
    """Floor division and modulo of negative numbers, W = 1, S = 2."""
    def addr_fn(s):
        return (s[0] - 500) // 7 + 300

    def step_fn(s, row):
        return (s[0] // -3 + row[0] % 11, s[1] + (-s[0]) % 9 - row[0] // -4)

    def out_fn(s):
        return s[0] % 50 + 50, 7                        # a constant output

    return addr_fn, step_fn, out_fn


@pytest.mark.parametrize("spec,s,w,n", [(_wide_spec, 8, 8, 1 << 16),
                                        (_floor_spec, 2, 1, 600)])
@pytest.mark.parametrize("m,rif,steps", [(0, 16, 3), (1000, 16, 5),
                                         (1000, 1, 5), (777, 7, 0)])
def test_ring_chase_matches_plain(cuda, spec, s, w, n, m, rif, steps):
    gen = torch.Generator(device=cuda).manual_seed(m + s)
    port = torch.randint(-1000, 1000, (n, w), generator=gen, device=cuda,
                         dtype=torch.int32)
    state0 = torch.randint(-(1 << 30), 1 << 30, (m * s,), generator=gen,
                           device=cuda, dtype=torch.int32)
    prog = cops.trace_chase(*spec(), s, w)
    before = rk.ring_chase.launches
    got = rk.ring_chase(port, state0, prog, rif=rif,
                        max_steps=steps, s_width=s)
    want = rk.ring_chase_plain(port, state0, prog, max_steps=steps,
                               s_width=s)
    ref = cops.run_numpy(prog, port.cpu().numpy(),
                         state0.cpu().numpy().reshape(m, s), steps)
    torch.cuda.synchronize()
    for g, p, r in zip(got, want, ref):
        assert torch.equal(g, p)
        assert np.array_equal(g.cpu().numpy(), r)
    assert rk.ring_chase.launches == before + (1 if m else 0)


def test_compiled_kernels_raise_on_bad_cuda_inputs(cuda):
    i32 = dict(dtype=torch.int32, device=cuda)
    port = torch.zeros((16, 4), **i32)
    with pytest.raises(TypeError):                        # float64 port
        rk.ring_gather(port.double(), torch.zeros(3, **i32), chunk=4, rif=2)
    with pytest.raises(ValueError):                       # int64 addresses
        rk.ring_gather(port, torch.zeros(3, dtype=torch.int64, device=cuda),
                       chunk=4, rif=2)
    with pytest.raises(ValueError):                       # rif above 16
        rk.ring_gather(port, torch.zeros(3, **i32), chunk=4, rif=17)
    with pytest.raises(ValueError):                       # addrs on the CPU
        rk.ring_gather(port, torch.zeros(3, dtype=torch.int32), chunk=4,
                       rif=2)
    with pytest.raises(TypeError):                        # float64 table
        gk.gather_rif(port.double(), torch.zeros(3, **i32))
    with pytest.raises(ValueError):                       # port_a width 2
        rk.ring_deref(torch.zeros((4, 2), **i32), port,
                      torch.zeros(3, **i32), chunk=4, rif_a=2, rif_b=2)
    with pytest.raises(TypeError):                        # float64 port_b
        rk.ring_deref(torch.zeros((4, 1), **i32), port.double(),
                      torch.zeros(3, **i32), chunk=4, rif_a=2, rif_b=2)
    with pytest.raises(ValueError):                       # chunk too large
        rk.ring_deref(torch.zeros((4, 1), **i32), port,
                      torch.zeros(3, **i32), chunk=1 << 20, rif_a=2, rif_b=2)
    prog = cops.trace_chase(*_floor_spec(), 2, 1)
    with pytest.raises(TypeError):                        # float port
        rk.ring_chase(torch.zeros((16, 1), device=cuda),
                      torch.zeros(4, **i32), prog, rif=2,
                      max_steps=1, s_width=2)
    with pytest.raises(ValueError):                       # traced for W=1
        rk.ring_chase(port, torch.zeros(4, **i32), prog, rif=2,
                      max_steps=1, s_width=2)
    with pytest.raises(ValueError):                       # S above 8
        cops.trace_chase(*_floor_spec(), 9, 1)
    with pytest.raises(ValueError):                       # W above 8
        cops.trace_chase(*_floor_spec(), 2, 9)


@pytest.mark.parametrize("name", sorted(COMPILE_TARGETS))
def test_compiled_targets_on_the_card(cuda, name):
    """Each target at "small" through its ring kernels on the card,
    bit-identical to the simulator oracle."""
    kern = {"gather": rk.ring_gather, "frontier_gather": rk.ring_deref,
            "spmv_gather": rk.ring_deref, "binsearch": rk.ring_chase,
            "binsearch_for": rk.ring_chase}[name]
    ck_, t = compile_target(name)
    assert ck_.device.type == "cuda"
    before = kern.launches
    assert_parity(ck_(), t.simulate_oracle())
    assert kern.launches == before + 1
    if name == "binsearch":
        with pytest.raises(CompileError, match="ChaseSpec"):
            from repro_torch.compile import compile_program
            compile_program(t.prog, t.memories)
