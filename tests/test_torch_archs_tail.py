"""Parity of the last decoder configurations with the JAX package's, on
the CPU: qwen2-72b (dense, ``qkv_bias``, ``rope_theta`` 1e6) and
chameleon-34b (family ``vlm``: early-fusion tokens through one ``attn``
segment, ``qk_norm``), and every config of ``repro.configs.ARCHS``.

The smoke configurations (2 layers, d_model 64, 4 heads over 2 KV
heads, float32) with JAX's random weights moved over by
``params_from_numpy``; qwen2-72b's ``bq``/``bk``/``bv`` are drawn
nonzero before they cross (JAX initialises them to zeros, which would
hide a missing add).  JAX runs in ``"pallas"`` (interpret mode) and
``"ref"`` for the cache-free forward, in ``"ref"`` for the cache paths
and serving; the port in both of its modes (``"kernel"`` takes the
kernels' plain versions on CPU tensors).

Tolerances, float32: logits and caches within 1e-5 (sums in other
orders); token streams equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serve_loop import PagedServeLoop as JaxPagedServeLoop
from repro.runtime.serve_loop import Request as JaxRequest
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.attention import GQAttention
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve_loop import PagedServeLoop, Request, ServeLoop

QWEN2, CHAMELEON, SEAMLESS = "qwen2-72b", "chameleon-34b", \
    "seamless-m4t-large-v2"
DECODERS = [QWEN2, CHAMELEON]
MODES = ["kernel", "ref"]
ATOL = 1e-5
B = 2


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = jax_get_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray, jax.jit(jax_build_model(cfg).init)(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for seg in tree["segments"]:
        for name in ("bq", "bk", "bv"):
            if name in seg["attn"]:
                seg["attn"][name] = rng.normal(
                    0, 0.5, seg["attn"][name].shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), tree


@functools.lru_cache(maxsize=None)
def _jax(arch, mode="ref"):
    cfg = jax_get_config(arch, smoke=True, kernel_mode=mode)
    return (cfg, jax_build_model(cfg)) + _weights(arch)


@functools.lru_cache(maxsize=None)
def _port(arch, mode):
    cfg = get_config(arch, smoke=True, kernel_mode=mode)
    return (cfg, build_model(cfg, device="cpu"),
            params_from_numpy(cfg, _weights(arch)[1], device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# -- configs ------------------------------------------------------------------


def test_every_jax_arch_has_a_port_config():
    assert set(ARCHS) == set(JAX_ARCHS)
    assert len(ARCHS) == 10


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", [QWEN2, CHAMELEON, SEAMLESS])
def test_config_matches_jax(arch, smoke):
    mine = get_config(arch, smoke=smoke)
    ref = jax_get_config(arch, smoke=smoke)
    for f in dataclasses.fields(mine):
        if f.name != "kernel_mode":
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert mine.hd == ref.hd
    assert [(s.kind, s.count) for s in mine.layer_specs()] == \
        [(s.kind, s.count) for s in ref.layer_specs()]


def test_full_configs_name_their_features():
    qwen2, cham = get_config(QWEN2), get_config(CHAMELEON)
    assert qwen2.qkv_bias and qwen2.rope_theta == 1e6 and not qwen2.qk_norm
    assert cham.family == "vlm" and cham.qk_norm and not cham.qkv_bias
    assert [(s.kind, s.count) for s in cham.layer_specs()] == [("attn", 48)]
    seamless = get_config(SEAMLESS)
    assert (seamless.n_enc_layers, seamless.n_layers) == (24, 24)
    assert get_config(SEAMLESS, smoke=True).n_enc_layers == 2


# -- qwen2-72b's QKV bias -----------------------------------------------------


def test_qkv_bias_leaves_are_float32_zeros_at_init():
    cfg = get_config(QWEN2, smoke=True)
    p = GQAttention(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
    hd = cfg.hd
    for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                    ("bv", cfg.n_kv_heads)):
        b = getattr(p, name)
        assert b.dtype == torch.float32 and tuple(b.shape) == (n * hd,)
        assert not bool(b.any())
    assert not hasattr(GQAttention(get_config(CHAMELEON, smoke=True),
                                   torch.device("cpu")), "bq")


def test_biases_cross_nonzero():
    _, tree = _weights(QWEN2)
    _, _, params = _port(QWEN2, "ref")
    back = params_to_numpy(params)
    for name in ("bq", "bk", "bv"):
        want = tree["segments"][0]["attn"][name]
        assert float(np.abs(want).max()) > 0
        np.testing.assert_array_equal(back["segments"][0]["attn"][name], want)


# -- the cache-free forward ---------------------------------------------------


@pytest.mark.parametrize("jax_mode,mode", [("pallas", "kernel"),
                                           ("ref", "ref")])
@pytest.mark.parametrize("arch", DECODERS)
def test_apply_matches_jax(arch, jax_mode, mode):
    _, jbundle, jparams, _ = _jax(arch, jax_mode)
    _, bundle, params = _port(arch, mode)
    tok = np.random.default_rng(2).integers(0, 512, (B, 24)).astype(np.int32)
    with torch.no_grad():
        _close(bundle.apply(params, _t(tok)), jbundle.apply(jparams,
                                                            jnp.asarray(tok)))


# -- the cache paths ----------------------------------------------------------


STEPS = [(4, (4, 2)), (4, (0, 3)), (1, (1, 1)), (1, (1, 0))]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_jax(arch, mode, paged):
    """Chunked fills with invalid tokens (a row with none), masked
    single-token steps, then one decode step (the unmasked
    ``decode_step`` on the contiguous cache, a one-token chunk on the
    paged one, whose kernel-mode step runs ``flash_decode_paged``'s plain
    version): logits and every cache leaf equal JAX's."""
    _, jbundle, jparams, _ = _jax(arch)
    cfg, bundle, params = _port(arch, mode)
    s_max, page = 16, 4
    table = (np.arange(B * s_max // page, dtype=np.int32) + 1).reshape(B, -1)
    if paged:
        n_pages = 1 + table.size
        jcache = jbundle.cache_init_paged(B, n_pages, page)
        cache = bundle.cache_init_paged(B, n_pages, page)
        jstep = functools.partial(jax.jit(jbundle.prefill_paged),
                                  page_table=jnp.asarray(table))
        step = functools.partial(bundle.prefill_paged, page_table=_t(table))
    else:
        jcache, cache = jbundle.cache_init(B, s_max), bundle.cache_init(B,
                                                                        s_max)
        jstep, step = jax.jit(jbundle.prefill), bundle.prefill
    rng = np.random.default_rng(0)
    pos = np.zeros(B, np.int32)
    with torch.no_grad():
        for width, n_valid in STEPS:
            tok = rng.integers(0, cfg.vocab, (B, width)).astype(np.int32)
            n_valid = np.asarray(n_valid, np.int32)
            want, jcache = jstep(jparams, jcache, jnp.asarray(tok),
                                 jnp.asarray(pos), jnp.asarray(n_valid))
            got, cache = step(params, cache, _t(tok), _t(pos), _t(n_valid))
            _close(got, want)
            pos += n_valid
        tok = np.array([5, 9], np.int32)
        if paged:
            ones = np.ones(B, np.int32)
            want, jcache = jstep(jparams, jcache, jnp.asarray(tok[:, None]),
                                 jnp.asarray(pos), jnp.asarray(ones))
            got, cache = step(params, cache, _t(tok[:, None]), _t(pos),
                              _t(ones))
        else:
            want, jcache = jbundle.decode_step(jparams, jcache,
                                               jnp.asarray(tok),
                                               jnp.asarray(pos))
            got, cache = bundle.decode_step(params, cache, _t(tok), _t(pos))
    _close(got, want)
    for seg, jseg in zip(cache, jcache):
        mine, ref = _leaves(seg), _leaves(jseg)
        assert set(mine) == set(ref)
        for k, v in mine.items():
            if k.endswith("len"):
                np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))
            else:
                _close(v, ref[k])


# -- serving ------------------------------------------------------------------


def _requests(req_cls, vocab):
    return [req_cls(rid=i, prompt=np.random.default_rng(n).integers(
        0, vocab, size=n), max_new=6) for i, n in enumerate((1, 5, 9, 18, 3))]


@functools.lru_cache(maxsize=None)
def _jax_streams(arch):
    jcfg, jbundle, jparams, _ = _jax(arch)
    return JaxPagedServeLoop(jcfg, jbundle, jparams, batch_slots=2, s_max=32,
                             chunk=4, page=8).run(
        _requests(JaxRequest, jcfg.vocab))


@pytest.mark.parametrize("loop_cls", [PagedServeLoop, ServeLoop])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", DECODERS)
def test_serve_streams_match_jax(arch, mode, loop_cls):
    """Both loops serve JAX's ``PagedServeLoop`` streams token for token;
    the paged loop pages (both configs' layer kinds are {attn})."""
    cfg, bundle, params = _port(arch, mode)
    kw = {"page": 8} if loop_cls is PagedServeLoop else {}
    loop = loop_cls(cfg, bundle, params, batch_slots=2, s_max=32, chunk=4,
                    **kw)
    got = loop.run(_requests(Request, cfg.vocab))
    assert got == _jax_streams(arch)
    assert sum(map(len, got.values())) == 30
    if loop_cls is PagedServeLoop:
        assert loop.paged and loop.stats.page_allocs > 0
