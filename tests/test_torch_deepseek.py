"""Parity of the port's deepseek-v2-lite-16b (MLA without a query rank,
a dense first layer, then MoE layers with shared experts) with the JAX
package's, on the CPU.

The smoke configuration (3 layers: one dense, two MoE of 8 experts
top-2 with the 2 shared experts kept; d_model 64, kv_lora_rank 32,
q_lora_rank 0, rope/nope/v head dims 16, float32, dropless capacity)
with JAX's own random weights, moved over by ``params_from_numpy``, in
both kernel modes (JAX's ``"pallas"`` in interpret mode against the
port's ``"kernel"``, which takes the kernels' plain versions on CPU
tensors; and ``"ref"``).  Held to JAX: the config and its segments at
full and at smoke size, ``mla_apply`` on the ``wq`` branch in its five
cache branches, ``moe_apply`` with shared experts (routing equal
first), ``lm_prefill`` / ``lm_decode_step`` paged and contiguous,
``ModelBundle.apply``, and the token streams of ``PagedServeLoop`` and
``ServeLoop`` (``tests/test_serve_loop.py``'s ``ALL_ARCHS`` cell).
Logits and layer outputs agree within 1e-4 (float32 sums in different
orders), written latents within 1e-5; lengths and token streams are
equal.  The port's decode steps against its own cache-free forward:
rtol and atol 5e-3, as ``tests/test_archs_smoke.py`` holds JAX's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as ja
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serve_loop import PagedServeLoop as JaxPagedServeLoop
from repro.runtime.serve_loop import Request as JaxRequest
from repro.runtime.serve_loop import ServeLoop as JaxServeLoop
from repro_torch.configs import get_config
from repro_torch.models import attention as ta
from repro_torch.models import moe
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve_loop import (PagedServeLoop, Request,
                                            ServeLoop)
from test_torch_mla import _case as mla_case

ARCH = "deepseek-v2-lite-16b"
ATOL = 1e-4
LATENT_ATOL = 1e-5
B, PAGE, NPB = 2, 8, 3
MODES = [("pallas", "kernel"), ("ref", "ref")]
STEPS = [(4, (4, 2)), (1, (1, 1)), (1, (1, 0))]
CPU = torch.device("cpu")

_CACHE = {}


def _jax(mode):
    """JAX's config, bundle and weights in ``mode``: one draw of the
    weights serves both modes."""
    key = ("jax", mode)
    if key not in _CACHE:
        if "params" not in _CACHE:
            cfg = jax_get_config(ARCH, smoke=True)
            params = jax.jit(jax_build_model(cfg).init)(
                jax.random.PRNGKey(0))
            _CACHE["params"] = (params, jax.tree.map(np.asarray, params))
        cfg = jax_get_config(ARCH, smoke=True, kernel_mode=mode)
        _CACHE[key] = (cfg, jax_build_model(cfg), *_CACHE["params"])
    return _CACHE[key]


def _port(jax_mode, mode):
    key = ("port", mode)
    if key not in _CACHE:
        cfg = get_config(ARCH, smoke=True, kernel_mode=mode)
        _CACHE[key] = (cfg, build_model(cfg, device="cpu"),
                       params_from_numpy(cfg, _jax(jax_mode)[3],
                                         device="cpu"))
    return _CACHE[key]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


# -- config, segments, parameters ---------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax(smoke):
    mine = get_config(ARCH, smoke=smoke)
    ref = jax_get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(mine):
        if f.name != "kernel_mode":
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    for prop in ("hd", "qk_nope", "v_hd", "n_experts_padded"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert [(s.kind, s.count) for s in mine.layer_specs()] == \
        [(s.kind, s.count) for s in ref.layer_specs()]
    assert mine.kernel_mode == "kernel"
    if smoke:
        assert (mine.n_layers, mine.n_experts, mine.top_k, mine.q_lora_rank,
                mine.n_shared_experts) == (3, 8, 2, 0, 2)
    else:
        assert (mine.n_layers, mine.d_model, mine.n_heads, mine.kv_lora_rank,
                mine.q_lora_rank, mine.qk_rope_dim, mine.qk_nope, mine.v_hd,
                mine.n_experts, mine.top_k, mine.moe_d_ff, mine.d_ff,
                mine.vocab) == (27, 2048, 16, 512, 0, 64, 128, 128, 64, 6,
                                1408, 10_944, 102_400)
        assert [(s.kind, s.count) for s in mine.layer_specs()] == \
            [("attn", 1), ("moe", 26)]


def test_convert_fills_the_two_segments():
    """The dense segment's MLP, the MoE segment's experts and shared
    MLP, and MLA's ``wq`` (no query rank) carry JAX's values."""
    _, _, _, tree = _jax("ref")
    cfg, _, params = _port("ref", "ref")
    dense, moe_seg = params.segments
    assert len(dense) == 1 and len(moe_seg) == 2
    attn = dense[0].attn
    assert hasattr(attn, "wq") and not hasattr(attn, "w_dq")
    np.testing.assert_array_equal(
        attn.wq.numpy(), tree["segments"][0]["attn"]["wq"][0])
    np.testing.assert_array_equal(
        dense[0].mlp.w_up.numpy(), tree["segments"][0]["mlp"]["w_up"][0])
    shared = tree["segments"][1]["moe"]["shared"]
    for i, layer in enumerate(moe_seg):
        assert not hasattr(layer, "mlp")
        np.testing.assert_array_equal(layer.moe.shared.w_down.numpy(),
                                      shared["w_down"][i])
        np.testing.assert_array_equal(
            layer.moe.w_gate.numpy(),
            tree["segments"][1]["moe"]["w_gate"][i])
    assert tuple(moe_seg[0].moe.shared.w_gate.shape) == (
        cfg.d_model, cfg.moe_d_ff * cfg.n_shared_experts)


# -- mla_apply on the wq branch, moe_apply with shared experts ----------------


@pytest.mark.parametrize("branch", ["free", "token", "chunk", "paged_chunk",
                                    "paged_token"])
@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_mla_apply_matches_jax(jax_mode, mode, branch):
    jcfg, _, jparams, _ = _jax(jax_mode)
    cfg, _, params = _port(jax_mode, mode)
    jp = jax.tree.map(lambda a: a[0], jparams["segments"][1]["attn"])
    p = params.segments[1][0].attn
    x, pos, cache, valid, table = mla_case(branch, cfg,
                                           np.random.default_rng(9))
    want, jcache = ja.mla_apply(
        jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
        cache=None if cache is None else {k: _j(v) for k, v in cache.items()},
        valid=_j(valid), page_table=_j(table))
    tcache = None if cache is None else {k: _t(v) for k, v in cache.items()}
    with torch.no_grad():
        got, gcache = ta.mla_apply(cfg, p, _t(x), _t(pos), cache=tcache,
                                   valid=_t(valid), page_table=_t(table))
    _close(got, want)
    if cache is None:
        return
    for k in jcache:
        if k == "len":
            np.testing.assert_array_equal(gcache[k].numpy(),
                                          np.asarray(jcache[k]))
        else:          # page 0 takes invalid tokens in either order
            first = 1 if k in ("ckvp", "krp") else 0
            _close(gcache[k][first:], np.asarray(jcache[k])[first:],
                   LATENT_ATOL)


@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_moe_apply_with_shared_experts_matches_jax(jax_mode, mode):
    jcfg, _, jparams, _ = _jax(jax_mode)
    cfg, _, params = _port(jax_mode, mode)
    jp = jax.tree.map(lambda a: a[1], jparams["segments"][1]["moe"])
    p = params.segments[1][1].moe
    assert hasattr(p, "shared")
    x = np.random.default_rng(6).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    jg, je = jmoe._route(jcfg, jp, jnp.asarray(x.reshape(16, -1)))
    g, e = moe._route(cfg, p, _t(x.reshape(16, -1)))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    want = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    with torch.no_grad():
        got = moe.moe_apply(cfg, p, _t(x))
    _close(got, want)


# -- the model ----------------------------------------------------------------


def _steps(vocab):
    rng = np.random.default_rng(0)
    pos = np.zeros(B, np.int32)
    for width, n_valid in STEPS:
        tok = rng.integers(0, vocab, (B, width)).astype(np.int32)
        n_valid = np.asarray(n_valid, np.int32)
        yield tok, pos.copy(), n_valid
        pos += n_valid


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_prefill_and_decode_match_jax(jax_mode, mode, paged):
    """Chunked fills with invalid tokens, then single-token steps, over
    latent pages or a contiguous latent cache; then the unmasked
    ``lm_decode_step`` on the contiguous cache."""
    jcfg, _, jparams, _ = _jax(jax_mode)
    cfg, _, params = _port(jax_mode, mode)
    jax_prefill = jax.jit(functools.partial(jt.lm_prefill, jcfg))
    kw, jkw = {}, {}
    if paged:
        n_pages = 1 + B * NPB
        table = np.arange(1, n_pages, dtype=np.int32).reshape(B, NPB)
        jcache = jt.lm_cache_init_paged(jcfg, B, n_pages, PAGE)
        cache = tt.lm_cache_init_paged(cfg, B, n_pages, PAGE, CPU)
        kw, jkw = {"page_table": _t(table)}, {"page_table": _j(table)}
    else:
        jcache = jt.lm_cache_init(jcfg, B, NPB * PAGE)
        cache = tt.lm_cache_init(cfg, B, NPB * PAGE, CPU)
    assert len(cache) == 2                            # dense, then MoE
    for tok, pos, n_valid in _steps(cfg.vocab):
        want, jcache = jax_prefill(jparams, jcache, _j(tok), _j(pos),
                                   _j(n_valid), **jkw)
        got, cache = tt.lm_prefill(cfg, params, cache, _t(tok), _t(pos),
                                   _t(n_valid), **kw)
        _close(got, want)
    for seg, jseg in zip(cache, jcache):
        np.testing.assert_array_equal(seg["attn"]["len"].numpy(),
                                      np.asarray(jseg["attn"]["len"]))
    if paged:
        return
    tok = np.array([5, 9], np.int32)
    pos = cache[0]["attn"]["len"][0].numpy().copy()
    want, jcache = jt.lm_decode_step(jcfg, jparams, jcache, _j(tok), _j(pos))
    got, cache = tt.lm_decode_step(cfg, params, cache, _t(tok), _t(pos))
    _close(got, want)
    for seg, jseg in zip(cache, jcache):
        for k in ("ckv", "kr"):
            _close(seg["attn"][k], np.asarray(jseg["attn"][k]), LATENT_ATOL)


@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_cache_free_forward_matches_jax(jax_mode, mode):
    _, jbundle, jparams, _ = _jax(jax_mode)
    cfg, bundle, params = _port(jax_mode, mode)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (B, 11)).astype(
        np.int32)
    _close(bundle.apply(params, _t(tok)), jbundle.apply(jparams, _j(tok)))


@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_decode_matches_prefill(jax_mode, mode):
    """``tests/test_archs_smoke.py::test_decode_matches_prefill_mla`` on
    the port: six decode steps give the cache-free forward's logits."""
    cfg, bundle, params = _port(jax_mode, mode)
    b, s = 1, 6
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))
    with torch.no_grad():
        full = bundle.apply(params, tok)
        cache = bundle.cache_init(b, s)
        outs = []
        for t in range(s):
            logits, cache = bundle.decode_step(
                params, cache, tok[:, t], torch.full((b,), t,
                                                     dtype=torch.int32))
            outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               full.float().numpy(), rtol=5e-3, atol=5e-3)


# -- serving ------------------------------------------------------------------


def _streams(loops, req_cls, cfg, bundle, params):
    prompts = [np.random.default_rng(n).integers(0, cfg.vocab, size=n)
               for n in (1, 5, 9, 18, 3)]
    return {name: cls(cfg, bundle, params, batch_slots=2, s_max=32, chunk=4,
                      **kw).run([req_cls(rid=i, prompt=p, max_new=6)
                                 for i, p in enumerate(prompts)])
            for name, cls, kw in loops}


@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_serve_streams_match_jax(jax_mode, mode):
    """Both loops' greedy token streams equal JAX's, token for token."""
    _, jbundle, jparams, _ = _jax(jax_mode)
    jcfg = _jax(jax_mode)[0]
    want = _streams((("contig", JaxServeLoop, {}),
                     ("paged", JaxPagedServeLoop, {"page": PAGE})),
                    JaxRequest, jcfg, jbundle, jparams)
    got = _streams((("contig", ServeLoop, {}),
                    ("paged", PagedServeLoop, {"page": PAGE})),
                   Request, *_port(jax_mode, mode))
    assert got == want
    assert got["paged"] == got["contig"]
    assert sum(len(v) for v in got["paged"].values()) == 30
