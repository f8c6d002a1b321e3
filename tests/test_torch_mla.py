"""Parity of the port's MLA decoder (minicpm3-4b) with the JAX package's,
on the CPU.

The smoke configuration (2 layers, d_model 64, kv_lora_rank 32,
q_lora_rank 32, rope/nope/v head dims 16, float32) with JAX's own random
weights, moved over by ``params_from_numpy``.  ``mla_apply`` is held to
JAX's in its four branches (cache-free, contiguous single-token, chunked
cache fill, paged latents at chunk and single-token width), the model
through ``lm_prefill`` and ``lm_decode_step`` (paged and contiguous),
and serving through ``tests/test_paged_serve.py``'s parity cell and its
copy-on-write cell, in both kernel modes (JAX's ``"pallas"``, its
``flash_decode`` in interpret mode, against the port's ``"kernel"``,
which takes the kernels' plain versions on CPU tensors).  Logits and
attention outputs agree within 1e-4 (float32 sums in different orders),
written latents within 1e-5; lengths, token streams and serving counters
are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as ja
from repro.models import transformer as jt
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serve_loop import PagedServeLoop as JaxPagedServeLoop
from repro.runtime.serve_loop import Request as JaxRequest
from repro.runtime.serve_loop import ServeLoop as JaxServeLoop
from repro_torch.configs import get_config
from repro_torch.models import attention as ta
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve_loop import (PagedServeLoop, Request,
                                            ServeLoop)

ARCH = "minicpm3-4b"
ATOL = 1e-4
LATENT_ATOL = 1e-5     # written latents: float32 products of the same inputs
B, PAGE, NPB, CHUNK = 2, 8, 3, 4
# JAX kernel_mode -> the port's
MODES = [("pallas", "kernel"), ("ref", "ref")]
STEPS = [(CHUNK, (4, 2)), (CHUNK, (3, 4)), (1, (1, 1)), (1, (1, 0))]
CPU = torch.device("cpu")

_CACHE = {}


def _jax(mode):
    key = ("jax", mode)
    if key not in _CACHE:
        cfg = jax_get_config(ARCH, smoke=True, kernel_mode=mode)
        bundle = jax_build_model(cfg)
        params = bundle.init(jax.random.PRNGKey(0))
        _CACHE[key] = (cfg, bundle, params, jax.tree.map(np.asarray, params))
    return _CACHE[key]


def _port(jax_mode, mode):
    key = ("port", mode)
    if key not in _CACHE:
        cfg = get_config(ARCH, smoke=True, kernel_mode=mode)
        _CACHE[key] = (cfg, build_model(cfg, device="cpu"),
                       params_from_numpy(cfg, _jax(jax_mode)[3],
                                         device="cpu"))
    return _CACHE[key]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


# -- config -------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax(smoke):
    mine = get_config(ARCH, smoke=smoke)
    ref = jax_get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(mine):
        if f.name != "kernel_mode":
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    for prop in ("hd", "qk_nope", "v_hd"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert mine.kernel_mode == "kernel"
    if not smoke:
        assert (mine.n_layers, mine.d_model, mine.n_heads, mine.kv_lora_rank,
                mine.q_lora_rank, mine.qk_rope_dim, mine.qk_nope,
                mine.v_hd) == (62, 2560, 40, 256, 768, 32, 64, 64)


# -- mla_apply, branch by branch ----------------------------------------------


def _layer(jax_mode, mode):
    """Layer 0's attention leaves: JAX's dict and the port's module."""
    jcfg, _, jparams, _ = _jax(jax_mode)
    cfg, _, params = _port(jax_mode, mode)
    jp = jax.tree.map(lambda a: a[0], jparams["segments"][0]["attn"])
    return jcfg, jp, cfg, params.segments[0][0].attn


def _case(branch, cfg, rng):
    """(x, positions, cache, valid, page_table) as numpy for ``branch``;
    caches hold random latents (lengths 3 and 5) so that attention reads
    old positions as well as the new ones."""
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    s = {"free": 7, "token": 1, "chunk": CHUNK, "paged_chunk": CHUNK,
         "paged_token": 1}[branch]
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    lens = np.array([3, 5], np.int32)
    if branch == "free":
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s))
        return x, np.ascontiguousarray(pos), None, None, None
    pos = lens[:, None] + np.arange(s, dtype=np.int32)[None]
    valid = None
    if branch != "token":
        half = [True] * (s // 2) + [False] * (s - s // 2)
        valid = np.array([[True] * s, half])
    if branch.startswith("paged"):
        n_pages = 1 + B * NPB
        cache = {"ckvp": rng.standard_normal((n_pages, PAGE, r)),
                 "krp": rng.standard_normal((n_pages, PAGE, dr)), "len": lens}
        table = np.arange(1, n_pages, dtype=np.int32).reshape(B, NPB)[:, ::-1]
        table = np.ascontiguousarray(table)
    else:
        s_max = NPB * PAGE
        cache = {"ckv": rng.standard_normal((B, s_max, r)),
                 "kr": rng.standard_normal((B, s_max, dr)), "len": lens}
        table = None
    cache = {k: v.astype(np.float32) if k != "len" else v
             for k, v in cache.items()}
    return x, pos.astype(np.int32), cache, valid, table


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("branch", ["free", "token", "chunk", "paged_chunk",
                                    "paged_token"])
@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_mla_apply_matches_jax(jax_mode, mode, branch):
    jcfg, jp, cfg, p = _layer(jax_mode, mode)
    x, pos, cache, valid, table = _case(branch, cfg,
                                        np.random.default_rng(7))
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
        assert gcache is None and jcache is None
        return
    assert gcache is tcache and set(gcache) == set(jcache)
    for k in jcache:
        if k == "len":
            np.testing.assert_array_equal(gcache[k].numpy(),
                                          np.asarray(jcache[k]))
        elif k == "ckvp" or k == "krp":
            # page 0 is the trash page: several invalid tokens may land on
            # one of its slots, in either order; it is never attended
            np.testing.assert_allclose(gcache[k][1:].numpy(),
                                       np.asarray(jcache[k])[1:], rtol=0,
                                       atol=LATENT_ATOL)
        else:
            np.testing.assert_allclose(gcache[k].numpy(),
                                       np.asarray(jcache[k]), rtol=0,
                                       atol=LATENT_ATOL)


def test_mla_paged_needs_a_page_table():
    _, _, cfg, p = _layer("ref", "ref")
    x, pos, cache, valid, _ = _case("paged_chunk", cfg,
                                    np.random.default_rng(7))
    with pytest.raises(ValueError):
        ta.mla_apply(cfg, p, _t(x), _t(pos),
                     cache={k: _t(v) for k, v in cache.items()},
                     valid=_t(valid))


def test_v_pad_to_matches_jax():
    v = np.random.default_rng(0).standard_normal((2, 3, 5, 16)).astype(
        np.float32)
    got = ta.v_pad_to(torch.from_numpy(v), 32)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ja.v_pad_to(jnp.asarray(v), 32)))
    assert ta.v_pad_to(torch.from_numpy(v), 16).shape == v.shape


# -- the model: lm_prefill and lm_decode_step ---------------------------------


def _steps(vocab):
    rng = np.random.default_rng(0)
    pos = np.zeros(B, np.int32)
    for width, n_valid in STEPS:
        tok = rng.integers(0, vocab, (B, width)).astype(np.int32)
        n_valid = np.asarray(n_valid, np.int32)
        yield tok, pos.copy(), n_valid
        pos += n_valid


@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_paged_prefill_and_decode_match_jax(jax_mode, mode):
    jcfg, _, jparams, _ = _jax(jax_mode)
    cfg, _, params = _port(jax_mode, mode)
    n_pages = 1 + B * NPB
    table = np.arange(1, n_pages, dtype=np.int32).reshape(B, NPB)
    jcache = jt.lm_cache_init_paged(jcfg, B, n_pages, PAGE)
    cache = tt.lm_cache_init_paged(cfg, B, n_pages, PAGE, CPU)
    assert set(cache[0]["attn"]) == {"ckvp", "krp", "len"}
    assert tuple(cache[0]["attn"]["ckvp"].shape) == \
        tuple(jcache[0]["attn"]["ckvp"].shape)
    for tok, pos, n_valid in _steps(cfg.vocab):
        want, jcache = jt.lm_prefill(jcfg, jparams, jcache, jnp.asarray(tok),
                                     jnp.asarray(pos), jnp.asarray(n_valid),
                                     page_table=jnp.asarray(table))
        got, cache = tt.lm_prefill(cfg, params, cache, torch.from_numpy(tok),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(n_valid),
                                   page_table=torch.from_numpy(table))
        _close(got, want)
    np.testing.assert_array_equal(cache[0]["attn"]["len"].numpy(),
                                  np.asarray(jcache[0]["attn"]["len"]))


@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_contiguous_prefill_and_decode_match_jax(jax_mode, mode):
    jcfg, _, jparams, _ = _jax(jax_mode)
    cfg, _, params = _port(jax_mode, mode)
    s_max = NPB * PAGE
    jcache = jt.lm_cache_init(jcfg, B, s_max)
    cache = tt.lm_cache_init(cfg, B, s_max, CPU)
    assert set(cache[0]["attn"]) == {"ckv", "kr", "len"}
    for tok, pos, n_valid in _steps(cfg.vocab):
        want, jcache = jt.lm_prefill(jcfg, jparams, jcache, jnp.asarray(tok),
                                     jnp.asarray(pos), jnp.asarray(n_valid))
        got, cache = tt.lm_prefill(cfg, params, cache, torch.from_numpy(tok),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(n_valid))
        _close(got, want)
    tok = np.array([5, 9], np.int32)          # the unmasked decode step
    pos = cache[0]["attn"]["len"][0].numpy().copy()
    want, jcache = jt.lm_decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                     jnp.asarray(pos))
    got, cache = tt.lm_decode_step(cfg, params, cache, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
    _close(got, want)
    for k in ("ckv", "kr", "len"):
        np.testing.assert_allclose(cache[0]["attn"][k].numpy(),
                                   np.asarray(jcache[0]["attn"][k]), rtol=0,
                                   atol=LATENT_ATOL)


@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_cache_free_forward_matches_jax(jax_mode, mode):
    jcfg, jbundle, jparams, _ = _jax(jax_mode)
    cfg, bundle, params = _port(jax_mode, mode)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (B, 11)).astype(
        np.int32)
    want = jbundle.apply(jparams, jnp.asarray(tok))
    got = bundle.apply(params, torch.from_numpy(tok))
    _close(got, want)


# -- serving ------------------------------------------------------------------


def _prompt(n, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=n)


def _parity_streams(loop_classes, req_cls, cfg, bundle, params):
    prompts = [_prompt(n, cfg.vocab, seed=n) for n in (1, 5, 9, 18, 3)]
    out = {}
    for name, cls, kw in loop_classes:
        loop = cls(cfg, bundle, params, batch_slots=2, s_max=32, chunk=4,
                   **kw)
        out[name] = loop.run([req_cls(rid=i, prompt=p, max_new=6)
                              for i, p in enumerate(prompts)])
        out[name + "_allocs"] = loop.stats.page_allocs
    return out


@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_paged_parity_cell_matches_jax(jax_mode, mode):
    """``tests/test_paged_serve.py``'s paged-vs-contiguous cell for
    minicpm3-4b: both loops' token streams equal JAX's."""
    jcfg, jbundle, jparams, _ = _jax(jax_mode)
    want = _parity_streams((("contig", JaxServeLoop, {}),
                            ("paged", JaxPagedServeLoop, {"page": PAGE})),
                           JaxRequest, jcfg, jbundle, jparams)
    got = _parity_streams((("contig", ServeLoop, {}),
                           ("paged", PagedServeLoop, {"page": PAGE})),
                          Request, *_port(jax_mode, mode))
    assert want["paged"] == want["contig"]
    assert got["contig"] == want["contig"]
    assert got["paged"] == want["paged"]
    assert got["paged_allocs"] == want["paged_allocs"] > 0
    assert sum(len(v) for v in got["paged"].values()) == 30


def _cow_cell(loop_cls, req_cls, cfg, bundle, params):
    """Two prompts extending a served 18-token prefix (18 % 8 != 0) adopt
    its partial page and must copy it before writing; then the prefix is
    served again from its (clean) pages."""
    base = _prompt(18, cfg.vocab, seed=5)
    ext_b = np.concatenate([base, [7, 3]])
    ext_c = np.concatenate([base, [9]])
    loop = loop_cls(cfg, bundle, params, batch_slots=2, s_max=32, page=PAGE)
    out_a = loop.run([req_cls(rid=0, prompt=base, max_new=4)])[0]
    res = loop.run([req_cls(rid=1, prompt=ext_b, max_new=4),
                    req_cls(rid=2, prompt=ext_c, max_new=4)])
    again = loop.run([req_cls(rid=3, prompt=base, max_new=4)])[3]
    st = loop.stats
    return (out_a, res[1], res[2], again, st.cow_copies, st.prefix_hits,
            st.prefix_tokens_reused, st.page_allocs)


@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_prefix_reuse_and_copy_on_write_match_jax(jax_mode, mode):
    """Prefix reuse of latent pages and copy-on-write of a shared partial
    latent page: token streams and counters equal JAX's, the adopters'
    streams equal fresh unshared runs', and the donor's page stays clean
    (its prompt served again gives the same tokens)."""
    jcfg, jbundle, jparams, _ = _jax(jax_mode)
    want = _cow_cell(JaxPagedServeLoop, JaxRequest, jcfg, jbundle, jparams)
    cfg, bundle, params = _port(jax_mode, mode)
    got = _cow_cell(PagedServeLoop, Request, cfg, bundle, params)
    assert got == want
    assert got[4] >= 2 and got[5] >= 2          # cow copies, prefix hits
    assert got[3] == got[0]
    for stream, extra in ((got[1], [7, 3]), (got[2], [9])):
        prompt = np.concatenate([_prompt(18, cfg.vocab, seed=5), extra])
        solo = PagedServeLoop(cfg, bundle, params, batch_slots=1, s_max=32,
                              page=PAGE, prefix_reuse=False)
        assert solo.run([Request(rid=0, prompt=prompt, max_new=4)])[0] == \
            stream


def test_copy_pages_copies_latent_pages():
    """``lm_copy_pages`` copies every page pool a layer holds: MLA's
    latent pages, not only GQA's K/V pages."""
    cfg = _port("ref", "ref")[0]
    caches = tt.lm_cache_init_paged(cfg, B, 5, PAGE, CPU)
    gen = torch.Generator().manual_seed(0)
    for seg in caches:
        for k in ("ckvp", "krp"):
            seg["attn"][k].copy_(torch.randn(seg["attn"][k].shape,
                                             generator=gen))
    before = [{k: v.clone() for k, v in seg["attn"].items()}
              for seg in caches]
    tt.lm_copy_pages(caches, 2, 4)
    for seg, old in zip(caches, before):
        for k in ("ckvp", "krp"):
            a = seg["attn"][k]
            assert torch.equal(a[:, 4], old[k][:, 2])
            keep = [i for i in range(a.shape[1]) if i != 4]
            assert torch.equal(a[:, keep], old[k][:, keep])
