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
exact (copies and int32 arithmetic).  The tuner's tests tune every op on
the card, each into a cache file of its own, and hold the ``None``-knob
dispatch of the winner to the same limits.  A full-width train step
(depth 2, float32, TF32 off) is held to the CPU's: loss within 1e-5
relative, grad norm 1e-4, each gradient leaf within 1e-4 of its largest
|g|; a kernel-mode train step must raise on CUDA tensors.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.compile import CompileError
from repro_torch.bench.chases import (bptree, bptree_fns, bptree_state0,
                                     mix_fns)
from repro_torch.compile import chase as cops
from repro_torch.compile.targets import (COMPILE_TARGETS, assert_parity,
                                         compile_target)
from repro_torch.core import decouple as dec
from repro_torch.kernels.common import (GENERATED_BUILDS, GENERATED_DIR,
                                        build_kernels)
from repro_torch.kernels.compiled import kernel as rk
from repro_torch.kernels.dae_chase import kernel as ck
from repro_torch.kernels.dae_gather import kernel as gk
from repro_torch.kernels.dae_merge import kernel as mgk
from repro_torch.kernels.dae_merge.ops import _split_search, merge_path_splits
from repro_torch.kernels.dae_spmv import kernel as sk
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.grouped_matmul import kernel as mk
from repro_torch.tune.runners import KERNEL_DIMS

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _own_tune_cache(tmp_path, monkeypatch):
    """Dispatchers read the tune cache on None knobs: give each test an
    empty one (``--noconftest`` runs skip tests/conftest.py's)."""
    from repro_torch.tune import reset_default_cache
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune_cache.json"))
    reset_default_cache()
    yield
    reset_default_cache()


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
@pytest.mark.parametrize("d", [13, 200, 1536, 2560])
@pytest.mark.parametrize("m", [8, 256, 300, 4096])
def test_gather_matches_plain(cuda, dtype, d, m):
    """The main paths' M (a decode step's 8 rows, a prefill chunk's 256,
    granite's forward's 4096) at both models' widths, and odd widths."""
    gen = torch.Generator(device=cuda).manual_seed(d * m)
    n = 1000
    table = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    idx = torch.randint(0, n, (m,), generator=gen, device=cuda,
                        dtype=torch.int32)
    idx[:4] = torch.tensor([0, n - 1, 5, 5], dtype=torch.int32)
    before = gk.gather_rows.launches
    got = gk.gather_rows(table, idx)
    assert gk.gather_rows.launches == before + 1
    assert torch.equal(got, gk.gather_rows_plain(table, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [13, 1536])
def test_gather_unaligned_table(cuda, dtype, d):
    """A table view one element past a 16-byte boundary takes the element
    paths (4-byte words, or 2-byte elements)."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    n, m = 500, 257
    flat = torch.randn(n * d + 1, generator=gen, device=cuda).to(dtype)
    table = flat[1:].view(n, d)
    assert table.data_ptr() % 16
    idx = torch.randint(0, n, (m,), generator=gen, device=cuda,
                        dtype=torch.int32)
    got = gk.gather_rows(table, idx)
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
                                 (5, 64), (8, 64), (1, 96), (1, 192),
                                 (8, 192)])
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
                                      (8, 64, 16), (1, 96, 16), (1, 192, 16),
                                      (4, 192, 8)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("npb", [4, 40])
def test_decode_paged_splits_match_plain(cuda, dtype, g, d, b, npb):
    """8 KV heads, pages of 16: a 4-page table is one split, a 40-page
    one many (fk.paged_splits); lengths 1, 16, 17, the whole table and
    seeded; the default depth and explicit ones."""
    gen = torch.Generator(device=cuda).manual_seed(1000 * g + d + b + npb)
    kvh, page = 8, 16
    n_pages = 1 + b * npb
    q = torch.randn((b, kvh, g, d), generator=gen, device=cuda).to(dtype)
    kp = torch.randn((n_pages, kvh, page, d), generator=gen,
                     device=cuda).to(dtype)
    vp = torch.randn((n_pages, kvh, page, d), generator=gen,
                     device=cuda).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=cuda) + 1
    table = perm.to(torch.int32).reshape(b, npb).contiguous()
    lengths = _lengths(b, npb * page, page, gen, cuda)
    if b == 1:
        lengths[0] = npb * page
    want = fk.decode_paged_plain(q, kp, vp, table, lengths, scale=d ** -0.5)
    before = fk.flash_decode_paged.launches
    for rif in (None, 1, 16):
        got = fk.flash_decode_paged(q, kp, vp, table, lengths,
                                    scale=d ** -0.5, rif=rif)
        _close(got, want, dtype)
    assert fk.flash_decode_paged.launches == before + 3


@pytest.mark.parametrize("g,d,kvh", [(4, 128, 8), (1, 96, 40), (1, 192, 16)])
def test_decode_contig_launches_once_per_call(cuda, g, d, kvh):
    """One request of 2048 tokens splits across many CTAs (qwen3-4b's and
    MLA's decode shapes); the splits merge in the same launch."""
    gen = torch.Generator(device=cuda).manual_seed(kvh * d + g)
    s = 2048
    q = torch.randn((1, kvh, g, d), generator=gen, device=cuda).to(
        torch.bfloat16)
    kc = torch.randn((1, kvh, s, d), generator=gen, device=cuda).to(
        torch.bfloat16)
    vc = torch.randn_like(kc)
    lengths = torch.tensor([s], dtype=torch.int32, device=cuda)
    pps, nsplit = fk.paged_splits(1, kvh, -(-s // fk.DEFAULT_BK),
                                  torch.cuda.get_device_properties(
                                      cuda).multi_processor_count)
    assert nsplit > 1
    before = fk.flash_decode.launches
    got = fk.flash_decode(q, kc, vc, lengths, scale=d ** -0.5)
    assert fk.flash_decode.launches == before + 1
    _close(got, fk.decode_plain(q, kc, vc, lengths, scale=d ** -0.5),
           torch.bfloat16)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype,g,d,b,s", [
    (torch.bfloat16, 48, 128, 8, 1024),   # granite-34b's decode, 1 KV head
    (torch.bfloat16, 16, 128, 8, 1024),
    (torch.bfloat16, 13, 64, 3, 300),     # two sub-groups of 7, one row pad
    (torch.float32, 9, 192, 2, 200),
    (torch.float32, 48, 128, 1, 2048)])   # one request over many splits
def test_decode_wide_g_matches_plain(cuda, paged, dtype, g, d, b, s):
    """G above 8, in sub-groups of at most 8 rows over one read of each
    block: one KV head, blocks of 16, ragged lengths (1, 16, 17, S and
    seeded), against the plain decode."""
    gen = torch.Generator(device=cuda).manual_seed(g * d + b + paged)
    kvh, page = 1, fk.DEFAULT_BK
    scale = d ** -0.5
    q = torch.randn((b, kvh, g, d), generator=gen, device=cuda).to(dtype)
    lengths = _lengths(b, s, page, gen, cuda)
    if paged:
        npb = s // page
        n_pages = 1 + b * npb
        kp = torch.randn((n_pages, kvh, page, d), generator=gen,
                         device=cuda).to(dtype)
        vp = torch.randn_like(kp)
        perm = torch.randperm(n_pages - 1, generator=gen, device=cuda) + 1
        table = perm.to(torch.int32).reshape(b, npb).contiguous()
        fn, args = fk.flash_decode_paged, (q, kp, vp, table, lengths)
        want = fk.decode_paged_plain(*args, scale=scale)
    else:
        kc = torch.randn((b, kvh, s, d), generator=gen, device=cuda).to(dtype)
        vc = torch.randn_like(kc)
        fn, args = fk.flash_decode, (q, kc, vc, lengths)
        want = fk.decode_plain(*args, scale=scale)
    before = fn.launches
    for rif in (None, 4):
        _close(fn(*args, scale=scale, rif=rif), want, dtype)
    assert fn.launches == before + 2


def test_split_layout_matches_the_library(cuda):
    """``tests/test_torch_split_layout.py``'s mirror of the split-KV
    decodes' shared memory and partials is the compiled one."""
    from test_torch_split_layout import layout, partial_floats
    lib = fk._lib()
    for g in (1, 3, 8, 9, 13, 16, 48, 72):
        for d in (64, 128, 192):
            assert lib.split_decode_partial(g, d) == partial_floats(g, d)
            for page, depth, pps, nsplit, bf16 in ((16, 1, 4, 16, 1),
                                                   (8, 2, 15, 9, 0),
                                                   (16, 4, 4, 300, 1)):
                assert lib.split_decode_smem(
                    g, d, page, depth, pps, nsplit, bf16) == layout(
                    g, d, page, depth, pps, nsplit, 2 if bf16 else 4
                )["total"], (g, d, page, depth, pps, nsplit, bf16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,kvh,h0,h1,d", [(8, 8, 2, 4, 128),
                                           (12, 4, 3, 4, 128),
                                           (3, 8, 4, 6, 64)])
def test_decode_contig_head_view_matches_plain(cuda, dtype, g, kvh, h0, h1,
                                               d):
    """A tensor-parallel rank's KV heads ``cache[:, h0:h1]`` of a whole
    cache, read in place (batch rows ``kvh x S x D`` apart)."""
    gen = torch.Generator(device=cuda).manual_seed(g * d + h0)
    b, s = 5, 300
    q = torch.randn((b, h1 - h0, g, d), generator=gen,
                    device=cuda).to(dtype)
    kc = torch.randn((b, kvh, s, d), generator=gen, device=cuda).to(dtype)
    vc = torch.randn((b, kvh, s, d), generator=gen, device=cuda).to(dtype)
    lengths = _lengths(b, s, fk.DEFAULT_BK, gen, cuda)
    kv, vv = kc[:, h0:h1], vc[:, h0:h1]
    assert not kv.is_contiguous()
    before = fk.flash_decode.launches
    got = fk.flash_decode(q, kv, vv, lengths, scale=d ** -0.5)
    assert fk.flash_decode.launches == before + 1
    _close(got, fk.decode_plain(q, kv.contiguous(), vv.contiguous(),
                                lengths, scale=d ** -0.5), dtype)
    with pytest.raises(ValueError):       # two heads' rows apart
        fk.flash_decode(q[:, :1].expand(b, 2, g, d).contiguous(),
                        kc[:, :2, :s // 2], vc[:, :2, :s // 2],
                        lengths.clamp(max=s // 2), scale=d ** -0.5)


def test_decode_rejects_bad_inputs(cuda):
    q = torch.zeros((2, 2, 2, 16), device=cuda)
    kc = torch.zeros((2, 2, 8, 16), device=cuda)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                       # lengths dtype
        fk.flash_decode(q, kc, kc, lengths.long(), scale=0.25)
    with pytest.raises(TypeError):                        # mixed dtypes
        fk.flash_decode(q, kc.to(torch.bfloat16), kc, lengths, scale=0.25)
    with pytest.raises(ValueError):                       # no query row
        fk.flash_decode(torch.zeros((2, 2, 0, 16), device=cuda), kc, kc,
                        lengths, scale=0.25)
    with pytest.raises(ValueError):                       # G x D past smem
        fk.flash_decode(torch.zeros((2, 2, 80, 128), device=cuda),
                        torch.zeros((2, 2, 8, 128), device=cuda),
                        torch.zeros((2, 2, 8, 128), device=cuda), lengths,
                        scale=0.25)
    wide = torch.zeros((2, 2, 8, 256), device=cuda)
    with pytest.raises(ValueError):                       # D above 192
        fk.flash_decode(torch.zeros((2, 2, 2, 256), device=cuda), wide,
                        wide, lengths, scale=0.25)


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


@pytest.mark.parametrize("rif", [1, 2, 3, 16])
@pytest.mark.parametrize("bn", [128, 256])
def test_gmm_any_depth_on_wide_blocks(cuda, rif, bn):
    """Blocks of 128 real rows over four stages of D at every ring depth
    the tuner tries, one stage included: a wide block frees each stage
    one group late where the ring has two or more, and at once where it
    has one."""
    gen = torch.Generator(device=cuda).manual_seed(rif + bn)
    t, d, f, e = 256, 256, 256, 4
    x = torch.randn((t, d), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((e, d, f), generator=gen, device=cuda)
         * d ** -0.5).to(torch.bfloat16)
    be = torch.tensor([0, 3], dtype=torch.int32, device=cuda)
    got = mk.gmm(x, w, be, bt=128, rif=rif, _bn=bn)
    _close(got, mk.gmm_plain(x, w, be, bt=128), torch.bfloat16)


def _moe_blocks(cuda, tokens, d, f, seed, e=40, k=8):
    """chip_smoke.py's check_gmm inputs: granite's 40 experts, top-8 (or
    ``e`` experts, top-``k``), bt 128, ``tokens`` tokens routed at
    random, through the MoE dispatch's block layout."""
    from repro_torch.models import moe
    gen = torch.Generator(device=cuda).manual_seed(seed)
    bt = 128
    experts = torch.rand((tokens, e), generator=gen, device=cuda).topk(
        k, dim=-1).indices.to(torch.int32)
    _, se, stok, counts, pos = moe.sort_pairs(experts, e)
    tp, starts, be, rows = moe.block_layout(counts, tokens * k, bt)
    x = torch.randn((tokens, d), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    xs = x.new_zeros((tp, d))
    xs[starts[se] + pos] = x[stok]
    w = (torch.randn((e, d, f), generator=gen, device=cuda)
         * d ** -0.5).to(torch.bfloat16)
    return xs, w, be, rows


def _padding_zero(got, rows, bt):
    r = torch.arange(got.shape[0], device=got.device)
    pad = r % bt >= rows[r // bt]
    return bool((got[pad] == 0).all())


@pytest.mark.parametrize("tokens", [8, 256, 4096])  # decode, chunk, forward
@pytest.mark.parametrize("d,f", [(1536, 512), (512, 1536)])   # gate, down
def test_gmm_granite_layouts_match_plain(cuda, tokens, d, f):
    xs, w, be, rows = _moe_blocks(cuda, tokens, d, f, tokens)
    before = mk.gmm.launches
    got = mk.gmm(xs, w, be, bt=128, block_rows=rows)
    assert mk.gmm.launches == before + 1
    _close(got, mk.gmm_plain(xs, w, be, bt=128, block_rows=rows),
           torch.bfloat16)
    assert _padding_zero(got, rows, 128)


@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("tokens", [8, 256, 4096])  # decode, chunk, forward
@pytest.mark.parametrize("d,f", [(2048, 1408), (1408, 2048)])  # gate, down
def test_gmm_deepseek_layouts_match_plain(cuda, bn, tokens, d, f):
    """deepseek-v2-lite-16b's experts: 64, top-6, F 1408 (5.5 tiles of
    256 columns: the last one half past F) and D 1408 (22 stages of
    64)."""
    xs, w, be, rows = _moe_blocks(cuda, tokens, d, f, tokens + d, e=64,
                                  k=6)
    got = mk.gmm(xs, w, be, bt=128, block_rows=rows, _bn=bn)
    _close(got, mk.gmm_plain(xs, w, be, bt=128, block_rows=rows),
           torch.bfloat16)
    assert _padding_zero(got, rows, 128)


@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("path", ["narrow", "wide", "mixed"])
def test_gmm_paths_match_plain(cuda, bn, seed, path):
    """Every block narrow (1 to 64 real rows), every block wide (65 to
    128), or both with empty blocks, at both tile widths."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    e, d, f, bt, nb = 6, 1536, 512, 128, 12
    lo, hi = {"narrow": (1, 65), "wide": (65, 129), "mixed": (0, 129)}[path]
    rows = torch.randint(lo, hi, (nb,), generator=gen, device=cuda,
                         dtype=torch.int32)
    if path == "mixed":
        rows[:4] = torch.tensor([0, 64, 65, 128], dtype=torch.int32)
    be = torch.randint(0, e, (nb,), generator=gen, device=cuda,
                       dtype=torch.int32)
    x = torch.randn((nb * bt, d), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    w = (torch.randn((e, d, f), generator=gen, device=cuda)
         * d ** -0.5).to(torch.bfloat16)
    got = mk.gmm(x, w, be, bt=bt, block_rows=rows, _bn=bn)
    _close(got, mk.gmm_plain(x, w, be, bt=bt, block_rows=rows),
           torch.bfloat16)
    assert _padding_zero(got, rows, bt)


def test_gmm_is_deterministic_and_syncs_nothing(cuda):
    """Each output element is one warpgroup's sum over D in a fixed
    order: runs give the same bits.  The call reads block_rows only on
    the card."""
    xs, w, be, rows = _moe_blocks(cuda, 8, 1536, 512, 8)
    first = mk.gmm(xs, w, be, bt=128, block_rows=rows)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = mk.gmm(xs, w, be, bt=128, block_rows=rows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(first, again)
    for _ in range(3):
        assert torch.equal(first, mk.gmm(xs, w, be, bt=128, block_rows=rows))


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
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    with pytest.raises(ValueError):                       # tile width
        mk.gmm(xb, wb, be, bt=8, _bn=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,h,kvh,s,d", [
    (True, None, 4, 4, 128, 128),
    (True, None, 6, 2, 200, 64),      # GQA, S not a multiple of the block
    (True, 48, 4, 2, 300, 64),        # sliding window
    (False, None, 2, 1, 77, 16),
    (True, None, 3, 3, 1, 32),
    (True, None, 4, 4, 200, 96),      # MLA's dn + dr: minicpm3-4b
    (True, 48, 4, 2, 300, 96),
    (True, None, 2, 2, 1, 96),
    (True, None, 2, 2, 257, 192),     # deepseek-v2-lite-16b
    (True, 64, 2, 1, 300, 192),
    (False, None, 2, 2, 130, 192),
    (True, None, 2, 2, 1, 192)])
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


@pytest.mark.parametrize("sq,sk,b", [(1, 1000, 8), (32, 1000, 8),
                                     (1, 1024, 8), (2048, 1000, 2)])
def test_flash_bidirectional_cross_shapes_match_plain(cuda, sq, sk, b):
    """seamless-m4t-large-v2's cross attention (16 heads of 64, no mask):
    one query or a chunk against S_enc keys, S_enc not a multiple of the
    key block, and a long query block against a short key run."""
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn((b, 16, sq, 64), generator=gen, device=cuda).to(
        torch.bfloat16)
    k = torch.randn((b, 16, sk, 64), generator=gen, device=cuda).to(
        torch.bfloat16)
    v = torch.randn((b, 16, sk, 64), generator=gen, device=cuda).to(
        torch.bfloat16)
    kw = dict(causal=False, window=None, scale=0.125)
    before = fk.flash.launches
    got = fk.flash(q, k, v, **kw)
    assert fk.flash.launches == before + 1
    _close(got, fk.attention_plain(q, k, v, **kw), torch.bfloat16)


def test_encoder_layer_through_kernel_matches_plain(cuda):
    """One ``enc`` block of seamless-m4t-large-v2 at full width (d 1024,
    16 heads of 64, relu d_ff 8192), bf16, on 1000 positions: through
    ``flash`` with ``causal=False`` against the plain attention, held to
    4 bf16 ulps at the largest output (a rounding flip inside the
    attention moves the products after it by an ulp of their own
    size)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.blocks import Block, block_apply

    cfg = get_config("seamless-m4t-large-v2")
    gen = torch.Generator(device=cuda).manual_seed(0)
    blk = Block(cfg, "enc", cuda, gen)
    x = torch.randn((2, 1000, cfg.d_model), generator=gen,
                    device=cuda).to(torch.bfloat16)
    pos = torch.arange(1000, dtype=torch.int32, device=cuda).expand(2, 1000)
    out = {}
    for mode in ("kernel", "ref"):
        before = fk.flash.launches
        with torch.inference_mode():
            out[mode] = block_apply(dataclasses.replace(cfg, kernel_mode=mode),
                                    "enc", blk, x, pos)[0]
        assert fk.flash.launches == before + (mode == "kernel")
    err = float((out["kernel"].float() - out["ref"].float()).abs().max())
    assert err <= 2.0 ** -5 * float(out["ref"].float().abs().max()), err


def test_encdec_smoke_serve_through_kernels_matches_plain(cuda):
    """seamless-m4t-large-v2's smoke model (float32) serves requests
    with frames through the kernels (the encoder's and the cross
    attention's ``flash``, the decoder's ``flash_decode``) as through the
    plain path, in both loops."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serve_loop import (PagedServeLoop, Request,
                                                ServeLoop)

    out = {}
    for mode in ("kernel", "ref"):
        cfg = get_config("seamless-m4t-large-v2", smoke=True,
                         kernel_mode=mode)
        bundle = build_model(cfg)
        params = bundle.init(torch.Generator(device=cuda).manual_seed(0))
        rng = np.random.default_rng(0)
        frames = rng.standard_normal((4, 24, cfg.d_model)).astype(np.float32)
        for cls in (PagedServeLoop, ServeLoop):
            reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n),
                            max_new=8, frames=frames[i])
                    for i, n in enumerate((12, 3, 25, 7))]
            before = (fk.flash.launches, fk.flash_decode.launches)
            out[mode, cls] = cls(cfg, bundle, params, batch_slots=2,
                                 s_max=40, chunk=16).run(reqs)
            if mode == "kernel":
                assert fk.flash.launches > before[0]
                assert fk.flash_decode.launches > before[1]
    for cls in (PagedServeLoop, ServeLoop):
        assert out["kernel", cls] == out["ref", cls]


@pytest.mark.parametrize("d", [64, 96, 128, 192])
@pytest.mark.parametrize("rif", [None, 1, 3])
def test_flash_block_keys_match_plain(cuda, d, rif):
    """Every instantiated key block at each ring depth, causal and
    windowed, S not a multiple of any block."""
    gen = torch.Generator(device=cuda).manual_seed(d + (rif or 0))
    h, kvh, s = 4, 2, 389
    q = torch.randn((1, h, s, d), generator=gen, device=cuda).to(
        torch.bfloat16)
    k = torch.randn((1, kvh, s, d), generator=gen, device=cuda).to(
        torch.bfloat16)
    v = torch.randn((1, kvh, s, d), generator=gen, device=cuda).to(
        torch.bfloat16)
    keys = fk.prefill_block_keys(fk._prefill_lib(), d, True)
    assert len(keys) == 2
    for window in (None, 100):
        kw = dict(causal=True, window=window, scale=d ** -0.5)
        want = fk.attention_plain(q, k, v, **kw)
        for bk in keys:
            _close(fk.flash(q, k, v, rif=rif, bk=bk, **kw), want,
                   torch.bfloat16)


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
    with pytest.raises(ValueError):                       # bk not instantiated
        fk.flash(q.to(torch.bfloat16), q.to(torch.bfloat16),
                 q.to(torch.bfloat16), causal=True, window=None, scale=0.25,
                 bk=48)


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


def test_disaggregated_smoke_serve_matches_paged(cuda):
    """qwen3-4b's smoke model in kernel mode, its Access and Execute
    engines on two logical slots of the one card: the same streams as
    ``PagedServeLoop(prefix_reuse=False)``, one migration a request."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serve_meshes
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.mesh_serve import ShardedPagedServeLoop
    from repro_torch.runtime.serve_loop import PagedServeLoop, Request

    cfg = get_config("qwen3-4b", smoke=True, kernel_mode="kernel")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=cuda).manual_seed(0))

    def reqs():
        rng = np.random.default_rng(7)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n),
                        max_new=6) for i, n in enumerate((12, 3, 25, 7, 1, 18))]

    kw = dict(batch_slots=8, s_max=40, chunk=16, page=8)
    want = PagedServeLoop(cfg, bundle, params, prefix_reuse=False,
                          **kw).run(reqs())
    meshes = make_serve_meshes(2, devices=[cuda, cuda])
    before = fk.flash_decode_paged.launches
    loop = ShardedPagedServeLoop(cfg, bundle, params, meshes=meshes, **kw)
    assert loop.run(reqs()) == want
    assert fk.flash_decode_paged.launches > before
    assert loop.stats.migrations == 6
    assert loop.cache_pf[0]["attn"]["kp"].device.type == "cuda"


def test_engines_on_two_cards_serve_as_paged(cuda):
    """qwen3-4b's smoke model in kernel mode, prefill on card 0 and
    decode on card 1 of one process, card 0 current throughout: the
    same streams as ``PagedServeLoop(prefix_reuse=False)``, the decode
    kernels launched on card 1."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serve_meshes
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.mesh_serve import ShardedPagedServeLoop
    from repro_torch.runtime.serve_loop import PagedServeLoop, Request

    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    cfg = get_config("qwen3-4b", smoke=True, kernel_mode="kernel")
    bundle = build_model(cfg, device=cards[0])
    params = bundle.init(torch.Generator(device=cards[0]).manual_seed(0))

    def reqs():
        rng = np.random.default_rng(7)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n),
                        max_new=6) for i, n in enumerate((12, 3, 25, 7, 1, 18))]

    kw = dict(batch_slots=8, s_max=40, chunk=16, page=8)
    want = PagedServeLoop(cfg, bundle, params, prefix_reuse=False,
                          **kw).run(reqs())
    with torch.cuda.device(cards[0]):
        loop = ShardedPagedServeLoop(
            cfg, bundle, params, meshes=make_serve_meshes(2, devices=cards),
            **kw)
        before = fk.flash_decode_paged.launches
        assert loop.run(reqs()) == want
    assert fk.flash_decode_paged.launches > before
    assert loop.stats.migrations == 6
    assert loop.cache_pf[0]["attn"]["kp"].device == cards[0]
    assert loop.cache[0]["attn"]["kp"].device == cards[1]
    assert next(loop.params.parameters()).device == cards[1]


def test_one_rank_nccl_mesh_serves_as_paged(cuda):
    """A one-rank ``nccl`` group in this process: qwen3-4b's smoke model
    in kernel mode on ``make_serve_meshes(ranks=True)`` gathers its
    one-way sharded pool in every layer and serves
    ``PagedServeLoop``'s streams with its counters."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serve_meshes
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.mesh_serve import ShardedPagedServeLoop
    from repro_torch.runtime.serve_loop import PagedServeLoop, Request

    cfg = get_config("qwen3-4b", smoke=True, kernel_mode="kernel")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=cuda).manual_seed(0))

    def reqs():
        rng = np.random.default_rng(7)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n),
                        max_new=6) for i, n in enumerate((12, 3, 25, 7))]

    kw = dict(batch_slots=3, s_max=40, chunk=16, page=8)
    base = PagedServeLoop(cfg, bundle, params, **kw)
    want = base.run(reqs())
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        before = fk.flash_decode_paged.launches
        loop = ShardedPagedServeLoop(cfg, bundle, params,
                                     meshes=make_serve_meshes(ranks=True),
                                     **kw)
        assert loop.run(reqs()) == want
        assert fk.flash_decode_paged.launches > before
    finally:
        dist.destroy_process_group()
    assert loop._split["execute"]
    assert vars(loop.stats) == {**vars(base.stats), "ttft": loop.stats.ttft}


def test_mla_smoke_serve_through_kernels_matches_plain(cuda):
    """minicpm3-4b's smoke model (MLA, D = dn + dr = 32) serves the same
    tokens through the kernels as through the plain path, paged and
    contiguous; both decode through the contiguous ``flash_decode``,
    never the paged one (the reference's design)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serve_loop import (PagedServeLoop, Request,
                                                ServeLoop)

    out = {}
    for mode in ("kernel", "ref"):
        cfg = get_config("minicpm3-4b", smoke=True, kernel_mode=mode)
        bundle = build_model(cfg)
        params = bundle.init(torch.Generator(device=cuda).manual_seed(0))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, size=n)
                   for n in (12, 3, 25, 7, 1, 18)]
        for cls in (PagedServeLoop, ServeLoop):
            kw = {"page": 8} if cls is PagedServeLoop else {}
            before = (fk.flash_decode.launches,
                      fk.flash_decode_paged.launches)
            out[mode, cls.__name__] = cls(
                cfg, bundle, params, batch_slots=4, s_max=40, chunk=16,
                **kw).run([Request(rid=i, prompt=p, max_new=8)
                           for i, p in enumerate(prompts)])
            assert fk.flash_decode_paged.launches == before[1]
            assert (fk.flash_decode.launches > before[0]) is (mode == "kernel")
    ref = out["ref", "PagedServeLoop"]
    assert sum(len(v) for v in ref.values()) == 48
    for key, res in out.items():
        assert res == ref, key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_smoke_prefill_step_through_kernels_matches_plain(cuda, dtype):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.registry import build_model

    out = {}
    tok = torch.randint(0, 512, (2, 70), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    for mode in ("kernel", "ref"):
        cfg = get_config("minicpm3-4b", smoke=True, kernel_mode=mode,
                         dtype=str(dtype).split(".")[1])
        params = build_model(cfg).init(
            torch.Generator(device=cuda).manual_seed(0))
        before = fk.flash.launches
        out[mode] = make_prefill_step(cfg)(params, {"tokens": tok})
        assert fk.flash.launches == before + (2 if mode == "kernel" else 0)
    if dtype == torch.float32:
        torch.testing.assert_close(out["kernel"], out["ref"], rtol=0,
                                   atol=1e-4)
    else:
        limit = 2.0 ** -5 * float(out["ref"].abs().max())
        assert float((out["kernel"] - out["ref"]).abs().max()) <= limit


@pytest.mark.parametrize("paged", [True, False])
def test_mla_decode_at_minicpm3_head_dims_matches_plain(cuda, paged):
    """``mla_apply``'s decode in bfloat16 at minicpm3-4b's head dims (dn
    64 + dr 32 = D 96, V padded from 64) through ``flash_decode`` against
    the plain decode, on latent pages and on a contiguous latent cache."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import attention as ta

    full = get_config("minicpm3-4b")
    cfg = dataclasses.replace(get_config("minicpm3-4b", smoke=True),
                              n_heads=8, kv_lora_rank=full.kv_lora_rank,
                              q_lora_rank=64, qk_rope_dim=full.qk_rope_dim,
                              qk_nope_dim=full.qk_nope, v_head_dim=full.v_hd,
                              dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(5)
    p = ta.MLAttention(cfg, cuda, gen)
    b, page, npb = 3, 16, 8
    x = torch.randn((b, 1, cfg.d_model), generator=gen,
                    device=cuda).to(torch.bfloat16)
    lens = torch.tensor([1, 77, page * npb - 1], dtype=torch.int32,
                        device=cuda)
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    if paged:
        n = 1 + b * npb
        base = {"ckvp": torch.randn((n, page, r), generator=gen, device=cuda),
                "krp": torch.randn((n, page, dr), generator=gen, device=cuda)}
        perm = torch.randperm(b * npb, generator=gen, device=cuda) + 1
        kw = {"page_table": perm.to(torch.int32).reshape(b, npb)}
    else:
        s_max = page * npb
        base = {"ckv": torch.randn((b, s_max, r), generator=gen, device=cuda),
                "kr": torch.randn((b, s_max, dr), generator=gen, device=cuda)}
        kw = {}
    out = {}
    for mode in ("kernel", "ref"):
        c = dataclasses.replace(cfg, kernel_mode=mode)
        cache = {k: v.to(torch.bfloat16) for k, v in base.items()}
        cache["len"] = lens.clone()
        before = fk.flash_decode.launches
        out[mode], cache = ta.mla_apply(c, p, x, lens[:, None].clone(),
                                        cache=cache, **kw)
        assert fk.flash_decode.launches == before + (mode == "kernel")
        assert torch.equal(cache["len"], lens + 1)
    # one bf16 ulp of the attention output moves the bf16 product with
    # wo by an ulp of its own size: 4 ulps at the largest output
    got, want = out["kernel"].float(), out["ref"].float()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 2.0 ** -5 * float(
        want.abs().max())


def _prefill_pair(cfg, params, caches, tok, pos, n_valid, nxt, sync_free):
    """A chunked fill then a decode step on contiguous caches, the pair
    under ``set_sync_debug_mode("error")`` when ``sync_free``."""
    from repro_torch.models import transformer as tt
    if sync_free:
        torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            chunk, caches = tt.lm_prefill(cfg, params, caches, tok, pos,
                                          n_valid)
            step, caches = tt.lm_decode_step(cfg, params, caches, nxt,
                                             pos + n_valid)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return chunk, step, caches


@pytest.mark.parametrize("arch", ["qwen3-4b", "minicpm3-4b",
                                  "deepseek-v2-lite-16b"])
def test_contiguous_cache_steps_sync_nothing(cuda, arch):
    """GQA's K/V and MLA's latent caches written without a host sync:
    the smoke models' chunked fill (a chunk of 8 with invalid tokens,
    over caches already holding 0-6 tokens) and decode step through the
    kernels run under ``set_sync_debug_mode("error")`` and give the plain
    path's logits, caches and lengths."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    from repro_torch.models.registry import build_model

    b, chunk, s_max = 3, 8, 16
    gen = torch.Generator(device=cuda).manual_seed(1)
    tok = torch.randint(0, 512, (2, b, chunk), generator=gen, device=cuda,
                        dtype=torch.int32)
    nxt = torch.randint(0, 512, (b,), generator=gen, device=cuda,
                        dtype=torch.int32)
    first = torch.tensor([6, 1, 0], dtype=torch.int32, device=cuda)
    n_valid = torch.tensor([8, 3, 5], dtype=torch.int32, device=cuda)
    out = {}
    for mode in ("kernel", "ref"):
        cfg = get_config(arch, smoke=True, kernel_mode=mode)
        params = build_model(cfg).init(
            torch.Generator(device=cuda).manual_seed(0))
        caches = tt.lm_cache_init(cfg, b, s_max, cuda)
        zero = torch.zeros_like(first)
        with torch.inference_mode():       # fill 6, 1 and 0 tokens
            _, caches = tt.lm_prefill(cfg, params, caches, tok[0], zero,
                                      first)
        out[mode] = _prefill_pair(cfg, params, caches, tok[1], first,
                                  n_valid, nxt, mode == "kernel")
    (kc, ks, kcache), (rc, rs, rcache) = out["kernel"], out["ref"]
    torch.testing.assert_close(kc, rc, rtol=0, atol=1e-4)
    torch.testing.assert_close(ks, rs, rtol=0, atol=1e-4)
    for seg_k, seg_r in zip(kcache, rcache):
        for key, v in seg_k["attn"].items():
            if key == "len":
                assert torch.equal(v, (first + n_valid + 1).expand_as(v))
                assert torch.equal(v, seg_r["attn"]["len"])
            else:
                torch.testing.assert_close(v, seg_r["attn"][key], rtol=0,
                                           atol=1e-5)


def _cache_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_cache_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_recurrent_cache_steps_sync_nothing(cuda, arch):
    """The recurrent families' smoke models (RWKV6's shift and WKV
    states; Hymba's K/V, conv window and SSM state): a chunked fill of 8
    with invalid tokens and a row of none, over caches already holding
    0-6 tokens, then a decode step, through the kernels under
    ``set_sync_debug_mode("error")``, give the plain path's logits and
    every cache leaf."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    from repro_torch.models.registry import build_model

    b, chunk, s_max = 3, 8, 16
    gen = torch.Generator(device=cuda).manual_seed(1)
    tok = torch.randint(0, 512, (2, b, chunk), generator=gen, device=cuda,
                        dtype=torch.int32)
    nxt = torch.randint(0, 512, (b,), generator=gen, device=cuda,
                        dtype=torch.int32)
    first = torch.tensor([6, 1, 0], dtype=torch.int32, device=cuda)
    n_valid = torch.tensor([8, 0, 5], dtype=torch.int32, device=cuda)
    out = {}
    for mode in ("kernel", "ref"):
        cfg = get_config(arch, smoke=True, kernel_mode=mode)
        params = build_model(cfg).init(
            torch.Generator(device=cuda).manual_seed(0))
        caches = tt.lm_cache_init(cfg, b, s_max, cuda)
        zero = torch.zeros_like(first)
        with torch.inference_mode():
            _, caches = tt.lm_prefill(cfg, params, caches, tok[0], zero,
                                      first)
        out[mode] = _prefill_pair(cfg, params, caches, tok[1], first,
                                  n_valid, nxt, mode == "kernel")
    (kc, ks, kcache), (rc, rs, rcache) = out["kernel"], out["ref"]
    torch.testing.assert_close(kc, rc, rtol=0, atol=1e-4)
    torch.testing.assert_close(ks, rs, rtol=0, atol=1e-4)
    for seg_k, seg_r in zip(kcache, rcache):
        ref = _cache_leaves(seg_r)
        for key, v in _cache_leaves(seg_k).items():
            if key.endswith("len"):
                assert torch.equal(v, (first + n_valid + 1).expand_as(v))
                assert torch.equal(v, ref[key])
            else:
                torch.testing.assert_close(v, ref[key], rtol=0, atol=1e-5)


def test_deepseek_smoke_serve_through_kernels_matches_plain(cuda):
    """deepseek-v2-lite-16b's smoke model (MLA without a query rank, a
    dense first layer, then MoE layers with shared experts) serves the
    same tokens through the kernels as through the plain path, paged and
    contiguous: the decodes through the contiguous ``flash_decode``, the
    experts through ``gmm``."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serve_loop import (PagedServeLoop, Request,
                                                ServeLoop)

    out = {}
    for mode in ("kernel", "ref"):
        cfg = get_config("deepseek-v2-lite-16b", smoke=True,
                         kernel_mode=mode)
        bundle = build_model(cfg)
        params = bundle.init(torch.Generator(device=cuda).manual_seed(0))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, size=n)
                   for n in (12, 3, 25, 7, 1, 18)]
        for cls in (PagedServeLoop, ServeLoop):
            kw = {"page": 8} if cls is PagedServeLoop else {}
            before = (fk.flash_decode.launches,
                      fk.flash_decode_paged.launches, mk.gmm.launches)
            out[mode, cls.__name__] = cls(
                cfg, bundle, params, batch_slots=4, s_max=40, chunk=16,
                **kw).run([Request(rid=i, prompt=p, max_new=8)
                           for i, p in enumerate(prompts)])
            assert fk.flash_decode_paged.launches == before[1]
            kernel = mode == "kernel"
            assert (fk.flash_decode.launches > before[0]) is kernel
            assert (mk.gmm.launches > before[2]) is kernel
    ref = out["ref", "PagedServeLoop"]
    assert sum(len(v) for v in ref.values()) == 48
    for key, res in out.items():
        assert res == ref, key


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-34b"])
def test_legacy_serve_through_kernels_matches_plain(cuda, arch):
    """The coupled ``LegacyServeLoop`` on the card: at four slots under
    the serve bench's "mixed" mix (its caches polluted past s_max) the
    kernels serve the plain path's tokens, one ``flash_decode`` a layer a
    step; at one slot it serves the decoupled loop's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serve_loop import (LegacyServeLoop, Request,
                                                ServeLoop)

    out = {}
    for mode in ("kernel", "ref"):
        cfg = get_config(arch, smoke=True, kernel_mode=mode)
        bundle = build_model(cfg)
        params = bundle.init(torch.Generator(device=cuda).manual_seed(0))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, size=(4, 48)[i % 2])
                   for i in range(6)]
        before = fk.flash_decode.launches
        loop = LegacyServeLoop(cfg, bundle, params, batch_slots=4, s_max=128)
        out[mode] = loop.run([Request(rid=i, prompt=p, max_new=16)
                              for i, p in enumerate(prompts)])
        assert loop.device.type == "cuda"
        assert int(loop.cache[0]["attn"]["len"].max()) > 128
        launched = fk.flash_decode.launches - before
        assert launched == (cfg.n_layers * loop.steps
                            if mode == "kernel" else 0)
        one = [Request(rid=0, prompt=prompts[1], max_new=8)]
        new = ServeLoop(cfg, bundle, params, batch_slots=1, s_max=64,
                        chunk=16).run(one)
        one = [Request(rid=0, prompt=prompts[1], max_new=8)]
        assert LegacyServeLoop(cfg, bundle, params, batch_slots=1,
                               s_max=64).run(one) == new
    assert out["kernel"] == out["ref"]
    assert sum(len(v) for v in out["ref"].values()) == 96


def test_serve_axis_on_the_card(cuda, tmp_path):
    """A two-cell ``serve`` axis through ``run_axis`` on the card: the
    report carries the card's backend, validates, and a second run
    diffs against the first with no finding but walls."""
    from repro_torch.bench import (BenchContext, Cell, CellResult,
                                   diff_reports, load_report, measure,
                                   run_axis)
    from repro_torch.bench import coords as make_coords
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import backend_tag
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serve_loop import (LegacyServeLoop, Request,
                                                ServeLoop)

    cfg = get_config("granite-34b", smoke=True)
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=cuda).manual_seed(0))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, size=20)

    def cell(cls, kw):
        def run(ctx):
            loop = cls(cfg, bundle, params, batch_slots=2, s_max=64, **kw)
            reqs = [Request(rid=0, prompt=prompt, max_new=6)]
            t = measure(lambda: loop.run(reqs), warm_reps=1)
            return CellResult(us_cold=t.us_cold, us_warm=t.us_warm,
                              derived={"tokens": 6})
        return Cell("serve", f"serve/smoke/{cls.__name__}",
                    make_coords("granite-34b-smoke", "serve",
                                engine="kernel", backend=backend_tag(cuda),
                                tenants=2, tuned=False), run)

    cells = [cell(ServeLoop, {"chunk": 8}), cell(LegacyServeLoop, {})]
    reports = []
    for i in range(2):
        out = tmp_path / str(i)
        out.mkdir()
        run_axis("serve", cells, BenchContext(), out_dir=out)
        reports.append(load_report(out / "BENCH_serve.json"))
    assert reports[0]["meta"]["backend"] == backend_tag(cuda) == "cuda:sm90"
    assert all(f.kind.startswith("wall-clock")
               for f in diff_reports(*reports))


def test_measure_waits_for_the_card(cuda):
    """``measure`` synchronises a CUDA result before reading the clock:
    a ~10 ms device spin is inside its warm time."""
    from repro_torch.bench import measure

    def spin():
        torch.cuda._sleep(20_000_000)
        return {"out": [torch.ones(1, device=cuda)]}

    t = measure(spin, warm_reps=2)
    assert t.us_warm > 1000.0


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


def _search_case(dtype, n, block, gen, dev, m):
    """A sorted table with duplicates, padded to whole blocks with the
    sentinel, and keys that hit the table's edges: below its first
    element, at its last, at the sentinel; float tables add -0.0 and
    +0.0 among the elements and the keys, and inf as a key."""
    table = _sorted_table(n, dtype, gen, dev)
    if dtype == torch.float32:
        table = table - table[n // 2]            # a run of zeros mid-table
        table[(table == 0).nonzero()[::2, 0]] = -0.0
    keys = table[torch.randint(0, n, (m,), generator=gen, device=dev)]
    big = float("inf") if dtype == torch.float32 else 2 ** 31 - 1
    edges = [float(table[0]) - 1, float(table[0]), float(table[-1]), big]
    if dtype == torch.float32:
        edges += [-0.0, 0.0, float("-inf")]
    edges = torch.tensor(edges, device=dev).to(dtype)[:m]
    keys[:edges.shape[0]] = edges
    padded = -(-n // block) * block
    tiles = torch.cat([table, table.new_full((padded - n,), big)]
                      ).reshape(-1, block)
    blk = (torch.searchsorted(tiles[:, 0].contiguous(), keys, right=True)
           - 1).clamp(0, tiles.shape[0] - 1).to(torch.int32)
    return table, tiles, blk, keys


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("block", [12, 16, 128, 256])
@pytest.mark.parametrize("n,m,chunk,rif", [
    (1001, 777, 64, None),             # n not a multiple of any block
    (5000, 3000, 1000, 16),            # chunk > a pass; the deepest plan
    (300, 50, 1000, 3),                # one CTA, chunk > M, rif not 2^k
    (4096, 1, 64, 1),                  # M = 1
    (2000, 129, 7, 2)])                # a ragged last CTA
def test_searchsorted_blocks_edges_match_plain(cuda, dtype, block, n, m,
                                               chunk, rif):
    """The unit search on duplicates, keys below the table and at the
    sentinel, and signed zeros and infinities for float32: equal to the
    plain version, to torch.searchsorted and across repeated runs, with
    no host sync."""
    gen = torch.Generator(device=cuda).manual_seed(n + m + block)
    table, tiles, blk, keys = _search_case(dtype, n, block, gen, cuda, m)
    want = ck.searchsorted_blocks_plain(tiles, blk, keys, n)
    assert torch.equal(want, torch.searchsorted(table, keys, right=True)
                       .to(torch.int32))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runs = [ck.searchsorted_blocks(tiles, blk, keys, n, chunk=chunk,
                                       rif=rif) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for got in runs:
        assert torch.equal(got, want)


def test_searchsorted_blocks_out_of_range_blocks(cuda):
    """Block ids below 0 and past NB are clamped into the table, as the
    plain version's gather of the clamped block."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    table = _sorted_table(1000, torch.int32, gen, cuda)
    tiles = torch.cat([table, table.new_full((24,), 2 ** 31 - 1)]
                      ).reshape(-1, 128)
    keys = table[torch.randint(0, 1000, (200,), generator=gen, device=cuda)]
    blk = torch.randint(-3, tiles.shape[0] + 3, (200,), generator=gen,
                        device=cuda, dtype=torch.int32)
    got = ck.searchsorted_blocks(tiles, blk, keys, 1000)
    want = ck.searchsorted_blocks_plain(
        tiles, blk.clamp(0, tiles.shape[0] - 1), keys, 1000)
    assert torch.equal(got, want)


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
    want = mgk.merge_tiles_plain(a, b, ia, ea, ib, eb, n + m, tile=tile)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(got, torch.sort(torch.cat([a, b])).values)


def _bits(x):
    return x.view(torch.int32)


def _sorted_runs(gen, dev, sizes, dtype, signed_zeros=False):
    """Sorted runs of keys with many ties; float runs with signed_zeros
    hold -0.0 and +0.0 in a random order among their zeros."""
    runs = []
    for size in sizes:
        x = torch.sort(torch.randint(-20, 20, (size,), generator=gen,
                                     device=dev)).values.to(dtype)
        if signed_zeros:
            flip = torch.rand((size,), generator=gen, device=dev) < 0.5
            x = torch.where((x == 0) & flip, torch.full_like(x, -0.0), x)
        runs.append(x)
    return runs


def test_merge_tiles_signed_zero_ties(cuda):
    """float32 runs full of ties and of both zeros: the kernel and the
    plain version place -0.0 and +0.0 alike (ties from a first)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    tile = 256
    a, b = _sorted_runs(gen, cuda, (5000, 3001), torch.float32, True)
    assert bool((_bits(a) == _bits(torch.tensor(-0.0))).any())
    n_tiles = -(-(8001) // tile)
    ia, ib = merge_path_splits(a, b, tile, n_tiles)
    ea, eb = torch.full_like(ia, 5000), torch.full_like(ib, 3001)
    got = mgk.merge_tiles(a, b, ia, ea, ib, eb, 8001, tile=tile)
    want = mgk.merge_tiles_plain(a, b, ia, ea, ib, eb, 8001, tile=tile)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("tile", [8, 64, 256, 1024])
def test_merge_tiles_any_starts(cuda, dtype, tile):
    """Starts that are not merge-path splits, in unaligned views: spans
    whose windows lie far apart overflow a stage and take the per-tile
    path, the rest the span path; n_out ragged."""
    gen = torch.Generator(device=cuda).manual_seed(tile)
    a_full, b_full = _sorted_runs(gen, cuda, (20_001, 9_003), dtype,
                                  dtype == torch.float32)
    a, b = a_full[1:], b_full[3:]                 # bases off 16 bytes
    n_tiles = 200
    sa = torch.randint(0, a.shape[0], (n_tiles,), generator=gen,
                       device=cuda, dtype=torch.int32)
    sb = torch.randint(0, b.shape[0], (n_tiles,), generator=gen,
                       device=cuda, dtype=torch.int32)
    sa[:64] = torch.arange(64, device=cuda, dtype=torch.int32) * 3
    sb[:64] = torch.arange(64, device=cuda, dtype=torch.int32) * 5
    ea = torch.full_like(sa, a.shape[0])
    eb = torch.randint(0, b.shape[0] + 1, (n_tiles,), generator=gen,
                       device=cuda, dtype=torch.int32)
    n_out = n_tiles * tile - 5
    got = mgk.merge_tiles(a, b, sa, ea, sb, eb, n_out, tile=tile)
    want = mgk.merge_tiles_plain(a, b, sa, ea, sb, eb, n_out, tile=tile)
    assert torch.equal(_bits(got), _bits(want))


def test_merge_tiles_sort_pass_layouts(cuda):
    """One tensor as both runs with per-tile ends, pairs of runs of widths
    tile, 2 tile and 4 tile: spans that cross pairs load one interval."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    tile, n = 256, 50_000
    for width in (tile, 2 * tile, 4 * tile):
        padded = -(-n // tile) * tile
        x = torch.randint(-1000, 1000, (padded,), generator=gen,
                          device=cuda, dtype=torch.int32)
        xp = torch.cat([torch.sort(c).values for c in x.split(width)])
        k = torch.arange(padded // tile, device=cuda) * tile
        a0 = k // (2 * width) * (2 * width)
        ks = k - a0
        na = (padded - a0).clamp(max=width)
        b0 = a0 + width
        nb = (padded - b0).clamp(0, width)
        ia = _split_search(xp, a0, na, xp, b0, nb, ks, 2 * width)
        i32 = torch.int32
        args = (xp, xp, (a0 + ia).to(i32), (a0 + na).to(i32),
                (b0 + ks - ia).to(i32), (b0 + nb).to(i32), padded)
        got = mgk.merge_tiles(*args, tile=tile)
        want = mgk.merge_tiles_plain(*args, tile=tile)
        assert torch.equal(got, want)


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


@pytest.mark.parametrize("ctas", [None, 0, 3])
@pytest.mark.parametrize("rif", [1, 2, 16])
@pytest.mark.parametrize("m,chunk", [(1, 64), (300, 64), (257, 100)])
def test_gather_rif_bulk_rows_match_plain(cuda, ctas, rif, m, chunk):
    """10 KB rows (qwen3-4b's embedding width in float32) through the bulk
    body: through ``gather_rif`` with its CTAs from the rule, and through
    ``ring_rows`` on one CTA a chunk and on three persistent ones, at
    several depths."""
    gen = torch.Generator(device=cuda).manual_seed(m + rif)
    table = torch.randn((500, 2560), generator=gen, device=cuda)
    idx = torch.randint(0, 500, (m,), generator=gen, device=cuda,
                        dtype=torch.int32)
    idx[0] = 499
    assert gk.bulk_rows(table, table)
    before = gk.gather_rif.launches
    if ctas is None:
        got = gk.gather_rif(table, idx, chunk=chunk, rif=rif)
    else:
        got = gk.ring_rows(table, idx, chunk, rif, (torch.float32,),
                           _ctas=ctas)
    torch.cuda.synchronize()
    assert torch.equal(got, gk.gather_rif_plain(table, idx))
    assert gk.gather_rif.launches == before + (ctas is None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rif_unaligned_table_takes_register_body(cuda, dtype):
    """A table view whose base is off 16 bytes cannot move as bulk
    copies: it takes the register body."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    n, d = 300, 256
    flat = torch.randn(n * d + 8, generator=gen, device=cuda).to(dtype)
    table = flat[2:2 + n * d].view(n, d)           # 4 or 8 bytes off
    assert not gk.bulk_rows(table, table)
    idx = torch.randint(0, n, (130,), generator=gen, device=cuda,
                        dtype=torch.int32)
    got = gk.gather_rif(table, idx, chunk=64, rif=4)
    torch.cuda.synchronize()
    assert torch.equal(got, gk.gather_rif_plain(table, idx))


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


@pytest.mark.parametrize("wb", [1, 3, 4, 32, 128])
@pytest.mark.parametrize("m,chunk,rif_a,rif_b,ctas", [
    (0, 64, 1, 1, None), (1, 64, 16, 16, None), (1, 1, 1, 1, None),
    (1000, 64, 1, 16, None), (1000, 64, 16, 1, None), (1000, 7, 2, 4, 3),
    (999, 100, 16, 16, 1000),          # more CTAs than chunks
    (3000, 33, 4, 16, 5)])             # ragged batches and chunks
def test_ring_deref_stream_matches_plain(cuda, wb, m, chunk, rif_a, rif_b,
                                         ctas):
    """The 16-byte row unit (WB 4, 32, 128) and the 4-byte one (WB 1, 3)
    at ragged streams, M = 0 and 1, rif_a / rif_b 1 and 16: equal to the
    plain version, across repeated runs, with no host sync; index values
    below 0 and past NB, a negative offset and indices near 2^31 - 1 in
    the 64-bit add."""
    gen = torch.Generator(device=cuda).manual_seed(wb * 7 + m)
    na, nb = 900, 500
    a = torch.randint(-60, nb + 60, (na, 1), generator=gen, device=cuda,
                      dtype=torch.int32)
    a[:5, 0] = torch.tensor([2 ** 31 - 1, -2 ** 31, 0, nb - 1, nb],
                            dtype=torch.int32)
    b = torch.randn((nb, wb), generator=gen, device=cuda)
    addrs = torch.randint(-5, na + 5, (m,), generator=gen, device=cuda,
                          dtype=torch.int32)
    if m:
        addrs[: min(m, 5)] = torch.arange(min(m, 5), dtype=torch.int32)
    for offset in (0, -7, 2 ** 31 - 1):
        want = rk.ring_deref_plain(a, b, addrs, offset=offset)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            runs = [rk.deref_rows(a, b, addrs, chunk=chunk, rif_a=rif_a,
                                  rif_b=rif_b, offset=offset, _ctas=ctas)
                    for _ in range(2)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for got_a, got_b in runs:
            assert got_a.shape == (m, 1) and got_b.shape == (m, wb)
            assert torch.equal(got_a, want[0])
            assert torch.equal(got_b, want[1])


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_ring_deref_unaligned_views_take_registers(cuda, dtype):
    """Data ports whose base is 4 or 8 bytes off 16 move in 4-byte
    units: equal to the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    nb, wb = 400, 32
    flat = (torch.randn(nb * wb + 4, generator=gen, device=cuda) * 1000
            ).to(dtype)
    a = torch.randint(0, nb, (300, 1), generator=gen, device=cuda,
                      dtype=torch.int32)
    addrs = torch.randint(0, 300, (777,), generator=gen, device=cuda,
                          dtype=torch.int32)
    for off in (1, 2):
        b = flat[off:off + nb * wb].view(nb, wb)
        got = rk.ring_deref(a, b, addrs, chunk=64, rif_a=2, rif_b=16,
                            offset=1)
        want = rk.ring_deref_plain(a, b, addrs, offset=1)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
                                         (1000, 1, 5), (777, 7, 0),
                                         (1000, 2, 5), (999, 7, 4)])
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


@pytest.mark.parametrize("s,w,m,rif", [(3, 9, 1000, 7), (4, 16, 2000, 16),
                                       (3, 17, 777, 5), (9, 32, 999, 8),
                                       (3, 256, 300, 3), (12, 5, 1000, 6),
                                       (2, 1024, 100, 1), (12, 3, 1, 1)])
def test_ring_chase_shared_memory_path_matches_plain(cuda, s, w, m, rif):
    """Programs past the register path, on the shared-memory path (named
    through the private ``_path`` where the rows are wide enough for the
    streamed path to be planned): widths of 4-byte and 16-byte copies,
    4 KB rows, a state of 12 words in registers and in shared memory (S
    12 at rif 6), ragged M."""
    gen = torch.Generator(device=cuda).manual_seed(w + s)
    port = torch.randint(-1000, 1000, (4096, w), generator=gen, device=cuda,
                         dtype=torch.int32)
    state0 = torch.randint(-(1 << 30), 1 << 30, (m * s,), generator=gen,
                           device=cuda, dtype=torch.int32)
    prog = cops.trace_chase(*mix_fns(s, w), s, w)
    assert not rk.chase_register_path(s, w)
    before = rk.ring_chase.launches
    got = rk.ring_chase(port, state0, prog, rif=rif, max_steps=4, s_width=s,
                        _path="smem")
    want = rk.ring_chase_plain(port, state0, prog, max_steps=4, s_width=s)
    ref = cops.run_numpy(prog, port.cpu().numpy(),
                         state0.cpu().numpy().reshape(m, s), 4)
    torch.cuda.synchronize()
    for g, p, r in zip(got, want, ref):
        assert torch.equal(g, p)
        assert np.array_equal(g.cpu().numpy(), r)
    assert rk.ring_chase.launches == before + 1


def test_ring_chase_unaligned_wide_port_matches_plain(cuda):
    """W 16 rows from a port that starts 4 bytes past a 16-byte boundary
    take the 4-byte copies."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    flat = torch.randint(-1000, 1000, (4096 * 16 + 4,), generator=gen,
                         device=cuda, dtype=torch.int32)
    port = flat[1:1 + 4096 * 16].view(4096, 16)
    state0 = torch.randint(-999, 999, (500 * 4,), generator=gen, device=cuda,
                           dtype=torch.int32)
    prog = cops.trace_chase(*mix_fns(4, 16), 4, 16)
    got = rk.ring_chase(port, state0, prog, rif=4, max_steps=3, s_width=4)
    want = rk.ring_chase_plain(port, state0, prog, max_steps=3, s_width=4)
    assert all(torch.equal(g, x) for g, x in zip(got, want))


@pytest.mark.parametrize("w", [16, 32])
def test_ring_chase_bptree_equals_searchsorted(cuda, w):
    """The B+-tree search over a sorted 2^16 table: the kernel equals its
    plain version and torch.searchsorted(right=True)."""
    rng = np.random.default_rng(w)
    table = np.cumsum(rng.integers(1, 16, 1 << 16)).astype(np.int32)
    keys = np.concatenate([table[rng.integers(0, len(table), 1500)],
                           rng.integers(-5, int(table[-1]) + 16, 1500)]
                          ).astype(np.int32)
    rows, offs = bptree(table, w)
    prog = cops.trace_chase(*bptree_fns(offs, w), 4, w)
    port = torch.from_numpy(rows).to(cuda)
    state0 = torch.from_numpy(bptree_state0(keys).reshape(-1)).to(cuda)
    kw = dict(max_steps=len(offs), s_width=4)
    got = rk.ring_chase(port, state0, prog, rif=9, **kw)
    want = rk.ring_chase_plain(port, state0, prog, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    lib = torch.searchsorted(torch.from_numpy(table).to(cuda),
                             torch.from_numpy(keys).to(cuda), right=True)
    assert torch.equal(got[1], lib.to(torch.int32))


@pytest.mark.parametrize("w", [2048, 4096])
def test_ring_chase_streamed_bptree_equals_searchsorted(cuda, w):
    """8 KB and 16 KB nodes over a sorted 2^18 table, past one warp's 32
    rows in 227 KB: the streamed path at the planned STREAM_DEPTH
    windows in flight equals the plain version and
    torch.searchsorted(right=True), in one launch."""
    rif = rk.chase_plan_rif(4, w, 8)
    assert rk.chase_path(4, w) == "stream" and rif == rk.STREAM_DEPTH
    rng = np.random.default_rng(w + rif)
    table = np.cumsum(rng.integers(1, 16, 1 << 18)).astype(np.int32)
    keys = np.concatenate([table[rng.integers(0, len(table), 1500)],
                           rng.integers(-5, int(table[-1]) + 16, 1501)]
                          ).astype(np.int32)
    rows, offs = bptree(table, w)
    prog = cops.trace_chase(*bptree_fns(offs, w), 4, w)
    port = torch.from_numpy(rows).to(cuda)
    state0 = torch.from_numpy(bptree_state0(keys).reshape(-1)).to(cuda)
    kw = dict(max_steps=len(offs), s_width=4)
    before = rk.ring_chase.launches
    got = rk.ring_chase(port, state0, prog, rif=rif, **kw)
    torch.cuda.synchronize()
    assert rk.ring_chase.launches == before + 1
    want = rk.ring_chase_plain(port, state0, prog, **kw)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    lib = torch.searchsorted(torch.from_numpy(table).to(cuda),
                             torch.from_numpy(keys).to(cuda), right=True)
    assert torch.equal(got[1], lib.to(torch.int32))


@pytest.mark.parametrize("s,w,m", [(70, 2049, 333), (3, 2048, 100),
                                   (5, 1792, 257)])
def test_ring_chase_streamed_path_matches_plain(cuda, s, w, m):
    """Programs on the streamed path: a state of 70 words (past the
    registers: a lane-major global scratch) on rows of 2049 words (past
    the shared-memory path's cap; 4-byte copies, a last unit of one
    word), 8 KB rows of 16-byte copies, and 7 KB rows, where the
    shared-memory path (named through the private ``_path``) runs too;
    ragged M.  Each equals its plain version and run_numpy."""
    gen = torch.Generator(device=cuda).manual_seed(w + s)
    port = torch.randint(-1000, 1000, (2048, w), generator=gen, device=cuda,
                         dtype=torch.int32)
    state0 = torch.randint(-(1 << 30), 1 << 30, (m * s,), generator=gen,
                           device=cuda, dtype=torch.int32)
    prog = cops.trace_chase(*mix_fns(s, w), s, w)
    assert rk.chase_stream_built(s, w)
    before = rk.ring_chase.launches
    got = rk.ring_chase(port, state0, prog, rif=rk.STREAM_DEPTH,
                        max_steps=3, s_width=s, _path="stream")
    want = rk.ring_chase_plain(port, state0, prog, max_steps=3, s_width=s)
    ref = cops.run_numpy(prog, port.cpu().numpy(),
                         state0.cpu().numpy().reshape(m, s), 3)
    torch.cuda.synchronize()
    for g, p, r in zip(got, want, ref):
        assert torch.equal(g, p)
        assert np.array_equal(g.cpu().numpy(), r)
    assert rk.ring_chase.launches == before + 1
    if rk.chase_warp_bytes(s, w, 1) <= 232_448:    # the other path too
        other = rk.ring_chase(port, state0, prog, rif=1, max_steps=3,
                              s_width=s, _path="smem")
        assert all(torch.equal(g, x) for g, x in zip(other, want))


def test_streamed_chase_second_call_builds_nothing(cuda):
    """A streamed program's kernel is built once: a second call through
    a new trace of the same spec adds no file and no build."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    port = torch.randint(-1000, 1000, (64, 2048), generator=gen,
                         device=cuda, dtype=torch.int32)
    state0 = torch.randint(-999, 999, (100 * 2,), generator=gen,
                           device=cuda, dtype=torch.int32)
    kw = dict(max_steps=2, s_width=2)
    rk.ring_chase(port, state0, cops.trace_chase(*mix_fns(2, 2048), 2, 2048),
                  rif=1, **kw)
    torch.cuda.synchronize()
    files = sorted(GENERATED_DIR.iterdir())
    builds = dict(GENERATED_BUILDS)
    prog = cops.trace_chase(*mix_fns(2, 2048), 2, 2048)
    got = rk.ring_chase(port, state0, prog, rif=1, **kw)
    want = rk.ring_chase_plain(port, state0, prog, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sorted(GENERATED_DIR.iterdir()) == files
    assert GENERATED_BUILDS == builds


@pytest.mark.parametrize("dtype,w", [(torch.float32, 65536),
                                     (torch.int32, 65537),
                                     (torch.bfloat16, 131073)])
@pytest.mark.parametrize("chunk,rif", [(64, 16), (7, 3)])
def test_ring_gather_rows_past_one_ring_stage(cuda, dtype, w, chunk, rif):
    """Rows of 256 KB and more than one ring slot can hold move in
    pieces: 16-byte rows through the bulk body, 4-byte and odd-width
    bf16 rows through the register body; ``ring_gather`` and
    ``gather_rif`` bit-equal to index_select."""
    gen = torch.Generator(device=cuda).manual_seed(w + chunk)
    n = 100
    port = (torch.randn((n, w), generator=gen, device=cuda) * 1000
            ).to(dtype)
    addrs = torch.randint(0, n, (64,), generator=gen, device=cuda,
                          dtype=torch.int32)
    addrs[0] = n - 1
    want = torch.index_select(port, 0, addrs)
    if dtype != torch.bfloat16:
        before = rk.ring_gather.launches
        got = rk.ring_gather(port, addrs, chunk=chunk, rif=rif)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert rk.ring_gather.launches == before + 1
    if dtype != torch.int32:
        got = gk.gather_rif(port, addrs, chunk=chunk, rif=rif)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_ring_chase_rif_that_does_not_fit_raises(cuda):
    """4 KB rows on the shared-memory path: rif 1 fits one warp's 32 rows
    in 227 KB, rif 2 does not, and raises with the bytes it needs rather
    than run anything.  (Rows this wide plan the streamed path.)"""
    port = torch.zeros((64, 1024), dtype=torch.int32, device=cuda)
    state0 = torch.zeros(64 * 2, dtype=torch.int32, device=cuda)
    prog = cops.trace_chase(*mix_fns(2, 1024), 2, 1024)
    before = rk.ring_chase.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        rk.ring_chase(port, state0, prog, rif=2, max_steps=1, s_width=2,
                      _path="smem")
    assert rk.ring_chase.launches == before
    assert rk.chase_warp_bytes(2, 1024, 1) <= 232_448 < \
        rk.chase_warp_bytes(2, 1024, 2)
    assert rk.chase_path(2, 1024) == "stream"


def test_chase_second_call_builds_nothing(cuda):
    """A program's kernel is built once: a second call, even through a
    new trace of the same spec, adds no file under build/repro_torch/chase
    and no build."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    port = torch.randint(-1000, 1000, (600, 1), generator=gen, device=cuda,
                         dtype=torch.int32)
    state0 = torch.randint(-999, 999, (64 * 2,), generator=gen, device=cuda,
                           dtype=torch.int32)
    kw = dict(max_steps=3, s_width=2)
    rk.ring_chase(port, state0, cops.trace_chase(*_floor_spec(), 2, 1),
                  rif=3, **kw)
    torch.cuda.synchronize()
    files = sorted(GENERATED_DIR.iterdir())
    builds = dict(GENERATED_BUILDS)
    prog = cops.trace_chase(*_floor_spec(), 2, 1)
    got = rk.ring_chase(port, state0, prog, rif=5, **kw)
    want = rk.ring_chase_plain(port, state0, prog, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sorted(GENERATED_DIR.iterdir()) == files
    assert GENERATED_BUILDS == builds


def test_chase_failed_build_raises(cuda):
    """nvcc's refusal reaches the caller; nothing falls back."""
    prog = cops.trace_chase(lambda s: s[0] + 7, lambda s, r: (s[0] + r[0],),
                            lambda s: (s[0], s[0]), 1, 1)
    source = prog.source
    prog.source = lambda: source() + "\n#error a deliberately broken kernel\n"
    port = torch.zeros((8, 1), dtype=torch.int32, device=cuda)
    state0 = torch.zeros(4, dtype=torch.int32, device=cuda)
    before = rk.ring_chase.launches
    with pytest.raises(RuntimeError, match="deliberately broken"):
        rk.ring_chase(port, state0, prog, rif=1, max_steps=1, s_width=1)
    assert rk.ring_chase.launches == before


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
    wide = cops.trace_chase(*mix_fns(2, 2048), 2, 2048)
    with pytest.raises(ValueError, match="window in flight"):  # rif 2
        rk.ring_chase(torch.zeros((4, 2048), **i32), torch.zeros(4, **i32),
                      wide, rif=rk.STREAM_DEPTH + 1, max_steps=1, s_width=2)
    # 8 KB rows, past one warp's 32 rows in shared memory, run
    port8k = torch.zeros((4, 2048), **i32)
    got = rk.ring_chase(port8k, torch.zeros(4, **i32), wide, rif=1,
                        max_steps=1, s_width=2)
    want = rk.ring_chase_plain(port8k, torch.zeros(4, **i32), wide,
                               max_steps=1, s_width=2)
    assert all(torch.equal(g, x) for g, x in zip(got, want))


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


# -- the tuner on the card ----------------------------------------------------


_BF16_OPS = ("flash_attention", "flash_decode", "flash_decode_paged",
             "grouped_matmul")


@pytest.mark.parametrize("op", sorted(KERNEL_DIMS))
def test_tune_kernel_on_the_card(cuda, op):
    """tune_kernel at KERNEL_DIMS by CUDA events, a second call that is a
    cache hit, then the dispatch with every knob None: the kernel gets the
    winner's knobs and its output equals the plain version's (exact, the
    bf16 limit, or SpMV's 1e-5 of the largest row sum of |val * vec|)."""
    from repro_torch.tune import kernel_runner, tune_kernel
    from repro_torch.tune.seam import seam_knobs, spied
    dims = KERNEL_DIMS[op]
    res = tune_kernel(op, device=cuda, max_evals=4, reps=1)
    assert res.evals > 0 and math.isfinite(res.best_score)
    assert res.best_score <= res.seed_score
    again = tune_kernel(op, device=cuda)
    assert again.evals == 0 and again.best == res.best
    measure, key, _ = kernel_runner(op, dims, device=cuda, reps=1)
    assert key.split("|")[3].startswith("cuda:sm")
    wrapper, want = seam_knobs(op, res.best, dims)
    got, seen = spied(op, lambda: measure.run(None))
    assert seen[wrapper] == want
    ref = measure.ref()
    if op in _BF16_OPS:
        _close(got, ref, torch.bfloat16)
    elif op == "dae_spmv":
        err = float((got[:ref.shape[0]] - ref).abs().max())
        assert err <= 1e-5 * measure.row_bound()
    else:
        assert torch.equal(got, ref)


def test_tune_kernel_contended_is_keyed_apart(cuda):
    from repro_torch.tune import default_cache, kernel_key, tune_kernel
    from repro_torch.tune.runners import time_callable
    solo = tune_kernel("dae_merge", device=cuda, max_evals=3, reps=1)
    duo = tune_kernel("dae_merge", device=cuda, max_evals=3, reps=1,
                      contenders=2)
    assert solo.evals > 0 and duo.evals > 0      # no hit on the solo key
    k1, _ = kernel_key("dae_merge", device=cuda)
    k2, _ = kernel_key("dae_merge", device=cuda, contenders=2)
    assert k1 != k2 and k1 in default_cache() and k2 in default_cache()
    streams = []

    def fn():
        streams.append(torch.cuda.current_stream(cuda).cuda_stream)
        return torch.ones(1 << 20, device=cuda).sum()

    assert time_callable(fn, reps=2, contenders=3, device=cuda) > 0.0
    # a warm makespan and two timed ones, each on three streams
    assert len(streams) == 9 and len(set(streams)) == 3


@pytest.mark.parametrize("name", ["gather", "binsearch_for"])
def test_tune_compiled_on_the_card(cuda, name):
    from repro_torch.tune import tune_compiled
    res = tune_compiled(name, device=cuda, max_evals=3, reps=1)
    assert res.evals == 3
    assert tune_compiled(name, device=cuda).evals == 0
    ck_, t = compile_target(name)
    assert all(p.source == "cache" for p in ck_.plans.values())
    assert_parity(ck_(), t.simulate_oracle())


# -- training -----------------------------------------------------------------


def _train_grads(cfg, tree, device, batch):
    """One ``train_step`` on ``device``: its loss, grad norm and a host
    copy of the gradients it handed the optimizer (in JAX's layout)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.optim import AdamW

    class Keep:
        grads = None

        def update(self, grads, state, params):
            self.grads = params_to_numpy(grads)
            return AdamW(lr=3e-4).update(grads, state, params)

    params = params_from_numpy(cfg, tree, device=device, dtype=cfg.pdtype)
    opt = Keep()
    _, _, m = make_train_step(cfg, opt, device)(params, AdamW().init(params),
                                                batch)
    return float(m["loss"]), float(m["grad_norm"]), opt.grads


def test_train_step_full_width_matches_cpu(cuda):
    """granite-moe-3b-a800m at full width, depth 2, float32 (TF32 off):
    one train step on the card against the same step on the CPU, loss
    within 1e-5 relative, grad norm 1e-4 and every gradient leaf within
    1e-4 of its largest |g|."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.models.transformer import LM
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m",
                                         kernel_mode="ref"),
                              n_layers=2, dtype="float32")
    tree = params_to_numpy(LM(cfg, torch.device("cpu"),
                              torch.Generator().manual_seed(0),
                              dtype=torch.float32))
    batch = SyntheticLM(cfg.vocab, 128, 1, seed=2).batch_at(0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lc, gc, grads_c = _train_grads(cfg, tree, cuda, batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    lh, gh, grads_h = _train_grads(cfg, tree, "cpu", batch)
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    assert abs(gc - gh) <= 1e-4 * abs(gh)
    flat_c = dict(_leaves(grads_c, ""))
    for path, h in _leaves(grads_h, ""):
        err = float(np.abs(flat_c[path] - h).max())
        assert err <= 1e-4 * float(np.abs(h).max()), path


def _leaves(tree, path):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m"])
def test_kernel_mode_train_step_raises_on_cuda(cuda, arch):
    """The kernels have no backward: a kernel-mode train step on CUDA
    tensors raises before any kernel launches, as JAX's ``pallas`` mode
    raises under ``value_and_grad``."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW
    cfg = get_config(arch, smoke=True, kernel_mode="kernel")
    params = build_model(cfg, cuda).init(
        torch.Generator(device=cuda).manual_seed(0), dtype=cfg.pdtype)
    batch = SyntheticLM(cfg.vocab, 16, 2).batch_at(0)
    before = (gk.gather_rows.launches, fk.flash.launches, mk.gmm.launches)
    with pytest.raises(NotImplementedError, match="kernel_mode='ref'"):
        make_train_step(cfg, AdamW(), cuda)(params, AdamW().init(params),
                                            batch)
    assert (gk.gather_rows.launches, fk.flash.launches,
            mk.gmm.launches) == before
    assert all(p.grad is None for p in params.parameters())


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m"])
def test_one_rank_nccl_sharded_steps_are_bit_equal(cuda, arch):
    """``chip_smoke.py`` phase 15 at smoke size: in a one-rank ``nccl``
    group the three sharded steps on a (1, 1) mesh give the unsharded
    steps' bits, through the kernels (prefill, serve) and in training
    (float32, ``ref`` mode)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel.sharding import param_shardings, place

    cfg = get_config(arch, smoke=True)
    bundle = steps.build_model(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = bundle.init(gen)
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=gen,
                           device=cuda, dtype=torch.int32)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_debug_mesh((1, 1), ("data", "model"), ranks=True)
        shards = place(params, mesh, param_shardings(params, mesh))
        want = steps.make_prefill_step(cfg)(params, {"tokens": tokens})
        step, _ = steps.shard_prefill_step(cfg, mesh,
                                           InputShape("p", 64, 4, "p"))
        before = fk.flash.launches
        assert torch.equal(step(shards, {"tokens": tokens}), want)
        assert fk.flash.launches == before + cfg.n_layers
        ref = steps.make_serve_step(cfg)
        step, _ = steps.shard_serve_step(cfg, mesh,
                                         InputShape("d", 32, 4, "decode"))
        ca, cb = bundle.cache_init(4, 32), bundle.cache_init(4, 32)
        tok, pos = tokens[:, 0], torch.zeros(4, dtype=torch.int32,
                                             device=cuda)
        for _ in range(3):
            la, ca = ref(params, ca, tok, pos)
            before = fk.flash_decode.launches
            lb, cb = step(shards, cb, tok, pos)
            assert fk.flash_decode.launches == before + cfg.n_layers
            assert torch.equal(la, lb)
            tok, pos = la.argmax(-1).to(torch.int32), pos + 1
        for x, y in zip(ca, cb):
            for k in x["attn"]:
                assert torch.equal(x["attn"][k], y["attn"][k])
        tcfg = get_config(arch, smoke=True, kernel_mode="ref")
        a = steps.build_model(tcfg).init(
            torch.Generator(device=cuda).manual_seed(1), dtype=tcfg.pdtype)
        b = place(steps.build_model(tcfg).init(
            torch.Generator(device=cuda).manual_seed(1), dtype=tcfg.pdtype),
            mesh, param_shardings(a, mesh))
        opt = steps.default_optimizer()
        sa, sb = opt.init(a), opt.init(b)
        ref = steps.make_train_step(tcfg, opt)
        step, _ = steps.shard_train_step(tcfg, mesh,
                                         InputShape("t", 64, 4, "train"),
                                         optimizer=opt)
        batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
        for _ in range(2):
            a, sa, ma = ref(a, sa, batch)
            b, sb, mb = step(b, sb, batch)
            assert float(ma["loss"]) == float(mb["loss"])
            assert float(ma["grad_norm"]) == float(mb["grad_norm"])
    finally:
        dist.destroy_process_group()
