"""Parity of the port's qwen3-4b decoder with the JAX package's, on the CPU.

The smoke configuration (2 layers, d_model 64, float32) with JAX's own
random weights, moved over by ``params_from_numpy``; the same token
streams go through ``lm_prefill`` (paged and contiguous, chunk 4, then
single-token and masked decode steps) and ``lm_decode_step`` in both
kernel modes.  Logits agree within 1e-4 (float32 sums in different
orders through two layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_numpy

ATOL = 1e-4
B, PAGE, NPB, CHUNK = 2, 8, 3, 4
# JAX kernel_mode -> the port's
MODES = [("pallas", "kernel"), ("ref", "ref")]

# (tokens per slot, n_valid per slot) of each step
STEPS = [(CHUNK, (4, 2)), (CHUNK, (3, 4)), (1, (1, 1)), (1, (1, 0))]

_JAX = {}


def _jax_model(mode):
    if mode not in _JAX:
        cfg = jax_get_config("qwen3-4b", smoke=True, kernel_mode=mode)
        params = jt.lm_init(cfg, jax.random.PRNGKey(0))
        _JAX[mode] = (cfg, params, jax.tree.map(np.asarray, params))
    return _JAX[mode]


def _models(jax_mode, mode):
    jcfg, jparams, tree = _jax_model(jax_mode)
    cfg = get_config("qwen3-4b", smoke=True, kernel_mode=mode)
    return jcfg, jparams, cfg, params_from_numpy(cfg, tree, device="cpu")


def _steps(vocab):
    rng = np.random.default_rng(0)
    pos = np.zeros(B, np.int32)
    for width, n_valid in STEPS:
        tok = rng.integers(0, vocab, (B, width)).astype(np.int32)
        n_valid = np.asarray(n_valid, np.int32)
        yield tok, pos.copy(), n_valid
        pos += n_valid


def test_config_matches_jax():
    mine = get_config("qwen3-4b")
    ref = jax_get_config("qwen3-4b")
    for f in dataclasses.fields(mine):
        if f.name != "kernel_mode":
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert mine.kernel_mode == "kernel"
    smoke = get_config("qwen3-4b", smoke=True, kernel_mode="pallas")
    jsmoke = jax_get_config("qwen3-4b", smoke=True)
    assert smoke.kernel_mode == "kernel"
    assert (smoke.n_layers, smoke.d_model, smoke.hd, smoke.n_kv_heads,
            smoke.vocab, smoke.dtype) == (jsmoke.n_layers, jsmoke.d_model,
                                          jsmoke.hd, jsmoke.n_kv_heads,
                                          jsmoke.vocab, jsmoke.dtype)


@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_paged_prefill_and_decode_match_jax(jax_mode, mode):
    jcfg, jparams, cfg, params = _models(jax_mode, mode)
    n_pages = 1 + B * NPB
    table = np.arange(1, n_pages, dtype=np.int32).reshape(B, NPB)
    jcache = jt.lm_cache_init_paged(jcfg, B, n_pages, PAGE)
    cache = tt.lm_cache_init_paged(cfg, B, n_pages, PAGE, torch.device("cpu"))
    for tok, pos, n_valid in _steps(cfg.vocab):
        want, jcache = jt.lm_prefill(jcfg, jparams, jcache, jnp.asarray(tok),
                                     jnp.asarray(pos), jnp.asarray(n_valid),
                                     page_table=jnp.asarray(table))
        got, cache = tt.lm_prefill(cfg, params, cache, torch.from_numpy(tok),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(n_valid),
                                   page_table=torch.from_numpy(table))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    np.testing.assert_array_equal(cache[0]["attn"]["len"].numpy(),
                                  np.asarray(jcache[0]["attn"]["len"]))


@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_contiguous_prefill_and_decode_match_jax(jax_mode, mode):
    jcfg, jparams, cfg, params = _models(jax_mode, mode)
    s_max = NPB * PAGE
    jcache = jt.lm_cache_init(jcfg, B, s_max)
    cache = tt.lm_cache_init(cfg, B, s_max, torch.device("cpu"))
    for tok, pos, n_valid in _steps(cfg.vocab):
        want, jcache = jt.lm_prefill(jcfg, jparams, jcache, jnp.asarray(tok),
                                     jnp.asarray(pos), jnp.asarray(n_valid))
        got, cache = tt.lm_prefill(cfg, params, cache, torch.from_numpy(tok),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(n_valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    # the unmasked single-token decode step (lm_decode_step)
    tok = np.array([5, 9], np.int32)
    pos = cache[0]["attn"]["len"][0].numpy().copy()
    want, _ = jt.lm_decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                jnp.asarray(pos))
    got, cache = tt.lm_decode_step(cfg, params, cache, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(cache[0]["attn"]["len"][0].numpy(),
                                  pos + 1)


def test_paged_helpers_match_jax():
    cfg = get_config("qwen3-4b", smoke=True)
    jcfg = jax_get_config("qwen3-4b", smoke=True)
    rng = np.random.default_rng(1)
    cache = tt.lm_cache_init_paged(cfg, B, 5, PAGE, torch.device("cpu"))
    jcache = jt.lm_cache_init_paged(jcfg, B, 5, PAGE)
    kp = rng.standard_normal(tuple(cache[0]["attn"]["kp"].shape)).astype(
        np.float32)
    cache[0]["attn"]["kp"].copy_(torch.from_numpy(kp))
    jcache[0]["attn"]["kp"] = jnp.asarray(kp)
    cache = tt.lm_copy_pages(cache, 2, 4)
    jcache = jt.lm_copy_pages(jcache, jnp.int32(2), jnp.int32(4))
    np.testing.assert_array_equal(cache[0]["attn"]["kp"].numpy(),
                                  np.asarray(jcache[0]["attn"]["kp"]))
    keep = np.array([True, False])
    new_lens = np.array([7, 3], np.int32)
    cache[0]["attn"]["len"].fill_(5)
    jcache[0]["attn"]["len"] = jnp.full_like(jcache[0]["attn"]["len"], 5)
    cache = tt.lm_paged_reset(cache, torch.from_numpy(keep),
                              torch.from_numpy(new_lens))
    jcache = jt.lm_paged_reset(jcache, jnp.asarray(keep),
                               jnp.asarray(new_lens))
    np.testing.assert_array_equal(cache[0]["attn"]["len"].numpy(),
                                  np.asarray(jcache[0]["attn"]["len"]))


def test_params_from_numpy_rejects_wrong_shapes():
    cfg = get_config("qwen3-4b", smoke=True)
    _, _, tree = _jax_model("ref")
    bad = dict(tree, embed=tree["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(cfg, bad, device="cpu")


def test_weights_stored_in_compute_dtype():
    """Matrix weights are stored once in cfg.dtype (bit-identical to
    JAX's per-call astype); the embedding table keeps param_dtype."""
    _, _, tree = _jax_model("ref")
    cfg = get_config("qwen3-4b", smoke=True, dtype="bfloat16")
    params = params_from_numpy(cfg, tree, device="cpu")
    wq = params.segments[0][0].attn.wq
    assert wq.dtype == torch.bfloat16 and params.embed.dtype == torch.float32
    want = np.asarray(jnp.asarray(tree["segments"][0]["attn"]["wq"][0])
                      .astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(wq.float().numpy(), want)
