"""Parity of the port's MoE path with the JAX package's, on the CPU.

``grouped_matmul`` with the JAX side in interpret mode (its Pallas
kernel) or its ``ref`` method, and the port's kernel wrapper (its plain
version on CPU tensors) or its oracle, on the same numpy inputs: a tail
block, ``T == 0``, a single expert, an expert no block routes to, and a
wrong ``block_expert`` length.  Then granite-moe-3b-a800m's smoke
configuration (float32, 2 layers, 8 experts top-2) with JAX's weights:
``moe_apply`` in both mode pairs (routing asserted equal first, so a
flipped expert shows as a routing mismatch and not as an output gap),
paged prefill and decode logits, and greedy token streams of the paged
serve loop on the parity cell of ``tests/test_paged_serve.py``.

Tolerances: grouped_matmul 1e-5 (float32 sums in different orders over
D <= 48); MoE outputs and logits 1e-4 (as ``test_torch_model.py``:
float32 through two layers); token streams and routing exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.grouped_matmul.ops import grouped_matmul as jax_gmm
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serve_loop import PagedServeLoop as JaxPagedServeLoop
from repro.runtime.serve_loop import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.kernels.grouped_matmul import kernel as gk
from repro_torch.models import moe
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve_loop import PagedServeLoop, Request

ARCH = "granite-moe-3b-a800m"
GMM_ATOL = 1e-5
ATOL = 1e-4
# JAX method / kernel_mode -> the port's
MODES = [("pallas", "kernel"), ("ref", "ref")]
B, PAGE, NPB, CHUNK = 2, 8, 3, 4
STEPS = [(CHUNK, (4, 2)), (CHUNK, (3, 4)), (1, (1, 1)), (1, (1, 0))]

_JAX = {}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_model(mode):
    if mode not in _JAX:
        cfg = jax_get_config(ARCH, smoke=True, kernel_mode=mode)
        params = jt.lm_init(cfg, jax.random.PRNGKey(0))
        _JAX[mode] = (cfg, params, jax.tree.map(np.asarray, params))
    return _JAX[mode]


def _models(jax_mode, mode):
    jcfg, jparams, tree = _jax_model(jax_mode)
    cfg = get_config(ARCH, smoke=True, kernel_mode=mode)
    return jcfg, jparams, cfg, params_from_numpy(cfg, tree, device="cpu")


# -- configuration ------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax(smoke):
    mine = get_config(ARCH, smoke=smoke)
    ref = jax_get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(mine):
        if f.name != "kernel_mode":
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert [(s.kind, s.count) for s in mine.layer_specs()] == \
        [(s.kind, s.count) for s in ref.layer_specs()]
    assert mine.hd == ref.hd and mine.n_experts_padded == ref.n_experts_padded


# -- grouped_matmul -----------------------------------------------------------

# (T, bt, E, block_expert): a tail block (T % bt != 0), a single expert,
# and an expert (1) that no block routes to
GMM_CASES = {
    "tail": (20, 8, 3, [0, 2, 1]),
    "single_expert": (16, 8, 1, [0, 0]),
    "empty_expert": (24, 8, 3, [0, 2, 2]),
}


@pytest.mark.parametrize("case", sorted(GMM_CASES))
@pytest.mark.parametrize("jax_method,method", MODES)
def test_grouped_matmul_matches_jax(case, jax_method, method):
    t, bt, e, be = GMM_CASES[case]
    rng = np.random.default_rng(t + e)
    d, f = 48, 40
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    be = np.asarray(be, np.int32)
    want = np.asarray(jax_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(be),
                              bt=bt, method=jax_method, interpret=True))
    got = grouped_matmul(_t(x), _t(w), _t(be), bt=bt, method=method).numpy()
    assert got.shape == (t, f)
    np.testing.assert_allclose(got, want, rtol=0, atol=GMM_ATOL)


@pytest.mark.parametrize("jax_method,method", MODES)
def test_grouped_matmul_empty_and_bad_length_match_jax(jax_method, method):
    w = np.ones((2, 16, 8), np.float32)
    x0 = np.zeros((0, 16), np.float32)
    be0 = np.zeros((0,), np.int32)
    want = jax_gmm(jnp.asarray(x0), jnp.asarray(w), jnp.asarray(be0), bt=8,
                   method=jax_method, interpret=True)
    got = grouped_matmul(_t(x0), _t(w), _t(be0), bt=8, method=method)
    assert tuple(got.shape) == tuple(want.shape) == (0, 8)
    x = np.ones((12, 16), np.float32)
    bad = np.zeros((3,), np.int32)              # 12 rows need 2 blocks of 8
    with pytest.raises(ValueError, match="block_expert"):
        jax_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bad), bt=8,
                method=jax_method, interpret=True)
    with pytest.raises(ValueError, match="block_expert"):
        grouped_matmul(_t(x), _t(w), _t(bad), bt=8, method=method)


def test_block_rows_give_exact_zero_rows():
    """Rows past a block's real count come out as exact zeros, which is
    what the dispatch's zero padding rows multiply to."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 16, 8)).astype(np.float32))
    be = torch.tensor([2, 0, 1], dtype=torch.int32)
    rows = torch.tensor([3, 8, 0], dtype=torch.int32)
    before = gk.gmm.launches
    got = grouped_matmul(x, w, be, bt=8, block_rows=rows)
    assert gk.gmm.launches == before           # CPU: the plain version
    masked = x.clone()
    masked[3:8] = 0
    masked[16:] = 0
    want = grouped_matmul(masked, w, be, bt=8, method="ref")
    assert torch.equal(got[3:8], torch.zeros(5, 8))
    assert torch.equal(got[16:], torch.zeros(8, 8))
    torch.testing.assert_close(got, want, rtol=0, atol=GMM_ATOL)


# -- the MoE layer ------------------------------------------------------------


def _layer(jax_mode, mode):
    jcfg, _, cfg, params = _models(jax_mode, mode)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      _jax_model(jax_mode)[2]["segments"][0]["moe"])
    return jcfg, jp, cfg, params.segments[0][0].moe


@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_moe_apply_matches_jax(jax_mode, mode):
    jcfg, jp, cfg, p = _layer(jax_mode, mode)
    x = np.random.default_rng(6).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    jg, je = jmoe._route(jcfg, jp, jnp.asarray(x.reshape(16, -1)))
    g, e = moe._route(cfg, p, _t(x.reshape(16, -1)))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    want = np.asarray(jmoe.moe_apply(jcfg, jp, jnp.asarray(x)))
    got = moe.moe_apply(cfg, p, _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_kernel_dispatch_matches_dropless_ref_dispatch():
    """With capacity for every pair, the capacity dispatch and the
    grouped-matmul dispatch compute the same layer."""
    _, _, cfg, p = _layer("ref", "ref")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, 5, cfg.d_model)).astype(np.float32))
    ref = moe.moe_apply(cfg, p, x, capacity_factor=float(cfg.n_experts))
    kern = moe.moe_apply(dataclasses.replace(cfg, kernel_mode="kernel"), p, x)
    torch.testing.assert_close(kern, ref, rtol=0, atol=1e-5)


# -- the model through a paged cache, and the serve loop ----------------------


@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_paged_prefill_and_decode_match_jax(jax_mode, mode):
    jcfg, jparams, cfg, params = _models(jax_mode, mode)
    n_pages = 1 + B * NPB
    table = np.arange(1, n_pages, dtype=np.int32).reshape(B, NPB)
    jcache = jt.lm_cache_init_paged(jcfg, B, n_pages, PAGE)
    cache = tt.lm_cache_init_paged(cfg, B, n_pages, PAGE, torch.device("cpu"))
    rng = np.random.default_rng(0)
    pos = np.zeros(B, np.int32)
    for width, n_valid in STEPS:
        tok = rng.integers(0, cfg.vocab, (B, width)).astype(np.int32)
        n_valid = np.asarray(n_valid, np.int32)
        want, jcache = jt.lm_prefill(jcfg, jparams, jcache, jnp.asarray(tok),
                                     jnp.asarray(pos), jnp.asarray(n_valid),
                                     page_table=jnp.asarray(table))
        got, cache = tt.lm_prefill(cfg, params, cache, _t(tok), _t(pos),
                                   _t(n_valid), page_table=_t(table))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        pos = pos + n_valid
    np.testing.assert_array_equal(cache[0]["attn"]["len"].numpy(),
                                  np.asarray(jcache[0]["attn"]["len"]))


def _parity_prompts(vocab):
    return [np.random.default_rng(n).integers(0, vocab, size=n)
            for n in (1, 5, 9, 18, 3)]


@pytest.mark.parametrize("mode", ["kernel", "ref"])
def test_paged_serve_streams_match_jax(mode):
    """The paged-vs-contiguous parity cell of ``tests/test_paged_serve.py``
    (prompts of 1, 5, 9, 18 and 3 tokens, 6 new each, 2 slots, s_max 32,
    chunk 4, page 8) through JAX's paged loop and the port's."""
    if "serve" not in _JAX:
        jcfg = jax_get_config(ARCH, smoke=True)
        bundle = jax_build_model(jcfg)
        loop = JaxPagedServeLoop(jcfg, bundle, _jax_model("ref")[1],
                                 batch_slots=2, s_max=32, chunk=4, page=8)
        _JAX["serve"] = (loop.run([JaxRequest(rid=i, prompt=p, max_new=6)
                                   for i, p in enumerate(
                                       _parity_prompts(jcfg.vocab))]),
                         loop.stats.page_allocs)
    want, want_allocs = _JAX["serve"]
    _, _, cfg, params = _models("ref", mode)
    loop = PagedServeLoop(cfg, build_model(cfg, device="cpu"), params,
                          batch_slots=2, s_max=32, chunk=4, page=8)
    got = loop.run([Request(rid=i, prompt=p, max_new=6)
                    for i, p in enumerate(_parity_prompts(cfg.vocab))])
    assert got == want
    assert loop.stats.page_allocs == want_allocs > 0
