"""Parity of the port's granite-34b (dense, 48 query heads over one KV
head, GELU MLP) with the JAX package's, on the CPU.

The full configuration and its smoke variant equal JAX's field for
field, and the full model has JAX's parameter count (88 layers, 33.96 B:
shapes only, on the meta device and through ``jax.eval_shape``).  The
smoke model (2 layers, d_model 64, 4 heads over 1 KV head: G 4,
float32) with JAX's random weights, moved over by
``params_from_numpy``, in both kernel modes (JAX's ``"pallas"`` in
interpret mode against the port's ``"kernel"``, which takes the
kernels' plain versions on CPU tensors; and ``"ref"``): ``lm_prefill``
and ``lm_decode_step`` paged and contiguous, the cache-free forward,
and both serve loops' token streams.  A G 48 variant (48 heads at
d_model 768, so head_dim 16) runs the same prefill and decode steps.
Logits agree within 1e-4 (float32 sums in different orders); lengths
and token streams are equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jt
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serve_loop import PagedServeLoop as JaxPagedServeLoop
from repro.runtime.serve_loop import Request as JaxRequest
from repro.runtime.serve_loop import ServeLoop as JaxServeLoop
from repro_torch.configs import get_config
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve_loop import (PagedServeLoop, Request,
                                            ServeLoop)

ARCH = "granite-34b"
ATOL = 1e-4
B, PAGE, NPB = 2, 8, 3
MODES = [("pallas", "kernel"), ("ref", "ref")]
STEPS = [(4, (4, 2)), (1, (1, 1)), (1, (1, 0)), (3, (3, 1)), (1, (1, 1))]
CPU = torch.device("cpu")
VARIANTS = {"smoke": {}, "g48": {"n_heads": 48, "d_model": 768}}


@functools.lru_cache(maxsize=None)
def _weights(variant):
    cfg = jax_get_config(ARCH, smoke=True, **VARIANTS[variant])
    params = jax.jit(jax_build_model(cfg).init)(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax(variant, mode):
    cfg = jax_get_config(ARCH, smoke=True, kernel_mode=mode,
                         **VARIANTS[variant])
    return cfg, jax_build_model(cfg), _weights(variant)[0]


@functools.lru_cache(maxsize=None)
def _port(variant, mode):
    cfg = get_config(ARCH, smoke=True, kernel_mode=mode, **VARIANTS[variant])
    return (cfg, build_model(cfg, device="cpu"),
            params_from_numpy(cfg, _weights(variant)[1], device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want), rtol=0, atol=atol)


# -- config -------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["full", "smoke", "g48"])
def test_config_matches_jax(variant):
    kw = dict(smoke=variant != "full", **VARIANTS.get(variant, {}))
    mine, ref = get_config(ARCH, **kw), jax_get_config(ARCH, **kw)
    for f in dataclasses.fields(mine):
        if f.name != "kernel_mode":
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert mine.hd == ref.hd
    assert [(s.kind, s.count) for s in mine.layer_specs()] == \
        [(s.kind, s.count) for s in ref.layer_specs()]
    g = mine.n_heads // mine.n_kv_heads
    if variant == "full":
        assert (mine.n_layers, mine.d_model, mine.n_heads, mine.n_kv_heads,
                mine.hd, mine.d_ff, mine.vocab, mine.mlp_kind, mine.dtype) \
            == (88, 6144, 48, 1, 128, 24_576, 49_152, "gelu", "bfloat16")
    assert g == {"full": 48, "smoke": 4, "g48": 48}[variant]
    assert mine.hd == {"full": 128, "smoke": 16, "g48": 16}[variant]


def test_full_parameter_count_matches_jax():
    cfg = get_config(ARCH)
    model = tt.LM(cfg, torch.device("meta"))
    n = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(jax_build_model(jax_get_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree.leaves(shapes))
    per_layer = sum(p.numel() for p in model.segments[0][0].parameters())
    assert per_layer == 379_072_512      # 77.1 M attention, 302 M MLP, norms
    assert n == 88 * per_layer + 2 * 49_152 * 6144 + 6144
    assert round(n / 1e9, 2) == 33.96


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
@pytest.mark.parametrize("variant", ["smoke", "g48"])
def test_prefill_and_decode_match_jax(variant, jax_mode, mode, paged):
    """Chunked fills with invalid tokens, then single-token steps (the
    decode kernels at G 4 or G 48), over pages or a contiguous cache;
    then the unmasked ``lm_decode_step`` on the contiguous cache."""
    jcfg, _, jparams = _jax(variant, jax_mode)
    cfg, _, params = _port(variant, mode)
    jax_prefill = jax.jit(functools.partial(jt.lm_prefill, jcfg))
    kw, jkw = {}, {}
    if paged:
        n_pages = 1 + B * NPB
        table = np.arange(1, n_pages, dtype=np.int32).reshape(B, NPB)
        jcache = jt.lm_cache_init_paged(jcfg, B, n_pages, PAGE)
        cache = tt.lm_cache_init_paged(cfg, B, n_pages, PAGE, CPU)
        kw, jkw = {"page_table": _t(table)}, {"page_table": jnp.asarray(table)}
    else:
        jcache = jt.lm_cache_init(jcfg, B, NPB * PAGE)
        cache = tt.lm_cache_init(cfg, B, NPB * PAGE, CPU)
    for tok, pos, n_valid in _steps(cfg.vocab):
        want, jcache = jax_prefill(jparams, jcache, jnp.asarray(tok),
                                   jnp.asarray(pos), jnp.asarray(n_valid),
                                   **jkw)
        with torch.no_grad():
            got, cache = tt.lm_prefill(cfg, params, cache, _t(tok), _t(pos),
                                       _t(n_valid), **kw)
        _close(got, want)
    np.testing.assert_array_equal(cache[0]["attn"]["len"].numpy(),
                                  np.asarray(jcache[0]["attn"]["len"]))
    if paged:
        return
    tok = np.array([5, 9], np.int32)
    pos = cache[0]["attn"]["len"][0].numpy().copy()
    want, jcache = jt.lm_decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                     jnp.asarray(pos))
    with torch.no_grad():
        got, cache = tt.lm_decode_step(cfg, params, cache, _t(tok), _t(pos))
    _close(got, want)
    for k in ("k", "v"):
        _close(cache[0]["attn"][k], np.asarray(jcache[0]["attn"][k]), 1e-5)


@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_cache_free_forward_matches_jax(jax_mode, mode):
    _, jbundle, jparams = _jax("smoke", jax_mode)
    _, bundle, params = _port("smoke", mode)
    tok = np.random.default_rng(2).integers(0, 512, (B, 11)).astype(np.int32)
    with torch.no_grad():
        got = bundle.apply(params, _t(tok))
    _close(got, jbundle.apply(jparams, jnp.asarray(tok)))


# -- serving ------------------------------------------------------------------


def _streams(loops, req_cls, cfg, bundle, params):
    prompts = [np.random.default_rng(n).integers(0, cfg.vocab, size=n)
               for n in (12, 3, 25, 7, 1, 18)]
    return {name: cls(cfg, bundle, params, batch_slots=4, s_max=40, chunk=16,
                      **kw).run([req_cls(rid=i, prompt=p, max_new=8)
                                 for i, p in enumerate(prompts)])
            for name, cls, kw in loops}


@pytest.mark.parametrize("jax_mode,mode", MODES)
@pytest.mark.parametrize("variant", ["smoke", "g48"])
def test_serve_streams_match_jax(variant, jax_mode, mode):
    """Both loops' greedy token streams equal JAX's, token for token
    (``benchmarks/serve_bench.py::paged_parity``'s cell)."""
    jcfg, jbundle, jparams = _jax(variant, jax_mode)
    want = _streams((("contig", JaxServeLoop, {}),
                     ("paged", JaxPagedServeLoop, {"page": PAGE})),
                    JaxRequest, jcfg, jbundle, jparams)
    got = _streams((("contig", ServeLoop, {}),
                    ("paged", PagedServeLoop, {"page": PAGE})),
                   Request, *_port(variant, mode))
    assert got == want
    assert got["paged"] == got["contig"]
    assert sum(len(v) for v in got["paged"].values()) == 48
