"""Parity of the port's recurrent families, RWKV6 (rwkv6-1.6b, family
``ssm``) and the Hymba hybrid (hymba-1.5b, family ``hybrid``), with the
JAX package's, on the CPU.

The smoke configurations (rwkv6: 2 ``rwkv`` layers, d_model 64, head
dim 16; hymba: a ``hymba_global`` then a ``hymba`` layer, 4 heads over
2 KV heads, window 32, SSM state 8; float32) with JAX's random weights
moved over by ``params_from_numpy``, in both kernel modes (JAX's
``"pallas"`` in interpret mode against the port's ``"kernel"``, which
takes the kernels' plain versions on CPU tensors; and ``"ref"``).

Tolerances, float32 throughout:

  * the mixers (``rwkv_time_apply``, ``rwkv_channel_apply``,
    ``ssm_apply``, ``_conv1d_causal``) and their states: 1e-5 (sums in
    other orders); a row with no valid token keeps its state bit for
    bit;
  * logits of ``apply``, ``decode_step`` and ``prefill``: 1e-4, the
    other model tests' limit; caches 1e-5;
  * token streams of ``ServeLoop``, ``PagedServeLoop`` (which falls back
    to the contiguous path: ``paged`` False, no page allocated) and
    ``LegacyServeLoop``: equal to JAX's;
  * the port's chunked fill against its own stepwise decode: rtol and
    atol 1e-5 with equal argmax (JAX's own rwkv6 pair differs by up to
    2.7e-6 there);
  * loss within 1e-6 relative of JAX's ``value_and_grad``, each gradient
    leaf within 1e-5 of its largest |g|; a ``make_train_step`` step's
    loss within 1e-6 relative, its grad norm within 1e-5 relative (the
    gradients' own differences, summed in another order), its updated
    parameters within 1e-6 wherever JAX's gradient stands clear of the
    gradient tolerance and of AdamW's eps (elsewhere the first step's
    g / (|g| + eps) turns a rounding difference of g into a large one of
    the update).

JAX's serving ignores the sliding window (its single-token decode has
``if window is not None: pass`` and its chunked fill is length-masked);
only its cache-free forward applies it.  The port follows it on both
paths, and ``test_window_served_past_the_window_follows_jax`` records
where the two paths of the reference part.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models.registry import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.runtime.serve_loop import LegacyServeLoop as JaxLegacyServeLoop
from repro.runtime.serve_loop import PagedServeLoop as JaxPagedServeLoop
from repro.runtime.serve_loop import Request as JaxRequest
from repro.runtime.serve_loop import ServeLoop as JaxServeLoop
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import rwkv, ssm
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime.serve_loop import (LegacyServeLoop, PagedServeLoop,
                                            Request, ServeLoop)

RWKV, HYMBA = "rwkv6-1.6b", "hymba-1.5b"
ARCHS = [RWKV, HYMBA]
MODES = [("pallas", "kernel"), ("ref", "ref")]
MIX_ATOL = 1e-5
ATOL = 1e-4
CACHE_ATOL = 1e-5
STEP_TOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5          # of each leaf's largest |g|
GNORM_RTOL = 1e-5
UPDATE_ATOL = 1e-6
B = 2


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = jax_get_config(arch, smoke=True)
    params = jax.jit(jax_build_model(cfg).init)(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax(arch, mode):
    cfg = jax_get_config(arch, smoke=True, kernel_mode=mode)
    return (cfg, jax_build_model(cfg)) + _weights(arch)


@functools.lru_cache(maxsize=None)
def _port(arch, mode):
    cfg = get_config(arch, smoke=True, kernel_mode=mode)
    return (cfg, build_model(cfg, device="cpu"),
            params_from_numpy(cfg, _weights(arch)[1], device="cpu"))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict cache (JAX's or the port's)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _seg_layer(tree, seg, i=0):
    return jax.tree.map(lambda a: a[i], tree["segments"][seg])


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch, smoke):
    mine = get_config(arch, smoke=smoke)
    ref = jax_get_config(arch, smoke=smoke)
    for f in dataclasses.fields(mine):
        if f.name != "kernel_mode":
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    for prop in ("hd", "dt_rank"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert [(s.kind, s.count) for s in mine.layer_specs()] == \
        [(s.kind, s.count) for s in ref.layer_specs()]
    if arch == HYMBA and not smoke:
        assert [(s.kind, s.count) for s in mine.layer_specs()] == [
            ("hymba_global", 1), ("hymba", 14), ("hymba_global", 1),
            ("hymba", 15), ("hymba_global", 1)]
    if arch == RWKV and not smoke:
        assert [(s.kind, s.count) for s in mine.layer_specs()] == \
            [("rwkv", 24)]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_primitives_only_for_attention_kinds(arch):
    bundle = build_model(get_config(arch, smoke=True), device="cpu")
    assert bundle.cache_init_paged is None and bundle.prefill_paged is None
    assert bundle.copy_pages is None and bundle.cache_reset_paged is None
    assert build_model(get_config("qwen3-4b", smoke=True),
                       device="cpu").cache_init_paged is not None


# -- the mixers ---------------------------------------------------------------


def _mixer_case(branch, b, s, d, rng):
    """Input x (B, S, D) and the valid mask of ``branch``: ``free`` (no
    state), ``token`` (one token, no mask), ``chunk`` (a state, a mask
    with a row of no valid token), ``full`` (a state, every token)."""
    if branch == "token":
        s = 1
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    valid = None
    if branch == "chunk":
        valid = np.arange(s)[None, :] < np.array([s - 2, 0, s])[:b, None]
    return x, valid


RWKV_BRANCHES = ["free", "token", "chunk", "full"]


def _rwkv_state(cfg, b, rng):
    h = cfg.d_model // cfg.rwkv_head_dim
    return {"shift": rng.standard_normal((b, cfg.d_model)).astype(np.float32),
            "wkv": rng.standard_normal((b, h, cfg.rwkv_head_dim,
                                        cfg.rwkv_head_dim)
                                       ).astype(np.float32) * 0.1}


@pytest.mark.parametrize("branch", RWKV_BRANCHES)
def test_rwkv_time_apply_matches_jax(branch):
    jcfg, _, jparams, _ = _jax(RWKV, "ref")
    cfg, _, params = _port(RWKV, "ref")
    rng = np.random.default_rng(1)
    x, valid = _mixer_case(branch, 3, 7, cfg.d_model, rng)
    state = None if branch == "free" else _rwkv_state(cfg, 3, rng)
    jp = _seg_layer(jparams, 0, 1)["time"]
    want, jst = jrwkv.rwkv_time_apply(
        jcfg, jp, jnp.asarray(x),
        None if state is None else {k: _j(v) for k, v in state.items()},
        valid=_j(valid))
    with torch.no_grad():
        got, st = rwkv.rwkv_time_apply(
            cfg, params.segments[0][1].time, _t(x),
            None if state is None else {k: _t(v) for k, v in state.items()},
            valid=_t(valid))
    _close(got, want, MIX_ATOL)
    if state is None:
        assert st is None and jst is None
        return
    for k in ("shift", "wkv"):
        _close(st[k], jst[k], MIX_ATOL)
    if valid is not None:           # row 1 has no valid token
        for k in ("shift", "wkv"):
            assert torch.equal(st[k][1], _t(state[k])[1]), k


@pytest.mark.parametrize("branch", RWKV_BRANCHES)
def test_rwkv_channel_apply_matches_jax(branch):
    jcfg, _, jparams, _ = _jax(RWKV, "ref")
    cfg, _, params = _port(RWKV, "ref")
    rng = np.random.default_rng(2)
    x, valid = _mixer_case(branch, 3, 7, cfg.d_model, rng)
    state = (None if branch == "free" else
             rng.standard_normal((3, cfg.d_model)).astype(np.float32))
    jp = _seg_layer(jparams, 0, 0)["chan"]
    want, jst = jrwkv.rwkv_channel_apply(jcfg, jp, jnp.asarray(x),
                                         _j(state), valid=_j(valid))
    with torch.no_grad():
        got, st = rwkv.rwkv_channel_apply(cfg, params.segments[0][0].chan,
                                          _t(x), _t(state), valid=_t(valid))
    _close(got, want, MIX_ATOL)
    if state is None:
        assert st is None
        return
    _close(st, jst, MIX_ATOL)
    if valid is not None:
        assert torch.equal(st[1], _t(state)[1])


def _ssm_state(cfg, b, rng):
    di = cfg.ssm_expand * cfg.d_model
    return {"conv": rng.standard_normal((b, cfg.ssm_conv - 1, di)
                                        ).astype(np.float32),
            "ssm": rng.standard_normal((b, di, cfg.ssm_state)
                                       ).astype(np.float32)}


@pytest.mark.parametrize("branch", RWKV_BRANCHES + ["free_odd"])
def test_ssm_apply_matches_jax(branch):
    """The three branches of ``ssm_apply``: no state (the associative
    scan, at an even and an odd length), one decode token, and the
    chunked fill with and without a mask."""
    jcfg, _, jparams, _ = _jax(HYMBA, "ref")
    cfg, _, params = _port(HYMBA, "ref")
    rng = np.random.default_rng(3)
    s = 13 if branch == "free_odd" else 8
    x, valid = _mixer_case(branch.split("_")[0], 3, s, cfg.d_model, rng)
    state = None if branch.startswith("free") else _ssm_state(cfg, 3, rng)
    jp = _seg_layer(jparams, 1)["ssm"]
    want, jst = jssm.ssm_apply(
        jcfg, jp, jnp.asarray(x),
        None if state is None else {k: _j(v) for k, v in state.items()},
        valid=_j(valid))
    with torch.no_grad():
        got, st = ssm.ssm_apply(
            cfg, params.segments[1][0].ssm, _t(x),
            None if state is None else {k: _t(v) for k, v in state.items()},
            valid=_t(valid))
    _close(got, want, MIX_ATOL)
    if state is None:
        assert st is None and jst is None
        return
    for k in ("conv", "ssm"):
        _close(st[k], jst[k], MIX_ATOL)
    if valid is not None:
        for k in ("conv", "ssm"):
            assert torch.equal(st[k][1], _t(state[k])[1]), k


@pytest.mark.parametrize("window", [False, True])
def test_conv1d_causal_matches_jax(window):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    init = (rng.standard_normal((2, 3, 12)).astype(np.float32) if window
            else None)
    want = jssm._conv1d_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               _j(init))
    got = ssm._conv1d_causal(_t(x), _t(w), _t(b), _t(init))
    _close(got, want, MIX_ATOL)


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
def test_associative_scan_matches_jax(n):
    """The odd/even recursion of ``jax.lax.associative_scan``, combining
    in its order: the scanned pairs equal JAX's bit for bit."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)

    def combine(l, r):
        return l[0] * r[0], r[1] + r[0] * l[1]
    wa, wb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ga, gb = ssm.associative_scan(_t(a), _t(b))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))


# -- the model ----------------------------------------------------------------


@pytest.mark.parametrize("jax_mode,mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_jax(arch, jax_mode, mode):
    """The cache-free forward (hymba's windowed layer through ``flash``
    in kernel mode, its SSM through the associative scan)."""
    _, jbundle, jparams, _ = _jax(arch, jax_mode)
    _, bundle, params = _port(arch, mode)
    tok = np.random.default_rng(2).integers(0, 512, (B, 40)).astype(np.int32)
    with torch.no_grad():
        _close(bundle.apply(params, _t(tok)), jbundle.apply(jparams, _j(tok)),
               ATOL)


STEPS = [(4, (4, 2)), (4, (0, 3)), (1, (1, 1)), (1, (1, 0))]


@pytest.mark.parametrize("jax_mode,mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, jax_mode, mode):
    """Chunked fills with invalid tokens (a row with none), masked
    single-token steps, then the unmasked ``decode_step``: logits and
    every cache leaf equal JAX's."""
    jcfg, jbundle, jparams, _ = _jax(arch, jax_mode)
    cfg, bundle, params = _port(arch, mode)
    jcache = jbundle.cache_init(B, 16)
    cache = bundle.cache_init(B, 16)
    jprefill = jax.jit(jbundle.prefill)
    rng = np.random.default_rng(0)
    pos = np.zeros(B, np.int32)
    for width, n_valid in STEPS:
        tok = rng.integers(0, cfg.vocab, (B, width)).astype(np.int32)
        n_valid = np.asarray(n_valid, np.int32)
        want, jcache = jprefill(jparams, jcache, _j(tok), _j(pos),
                                _j(n_valid))
        with torch.no_grad():
            got, cache = bundle.prefill(params, cache, _t(tok), _t(pos),
                                        _t(n_valid))
        _close(got, want, ATOL)
        pos += n_valid
    tok = np.array([5, 9], np.int32)
    want, jcache = jbundle.decode_step(jparams, jcache, _j(tok), _j(pos))
    with torch.no_grad():
        got, cache = bundle.decode_step(params, cache, _t(tok), _t(pos))
    _close(got, want, ATOL)
    for seg, jseg in zip(cache, jcache):
        mine, ref = _leaves(seg), _leaves(jseg)
        assert set(mine) == set(ref)
        for k, v in mine.items():
            if k.endswith("len"):
                np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))
            else:
                _close(v, ref[k], CACHE_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_fill_matches_stepwise_decode(arch):
    """The port's chunked cache fill (chunks of 4) against its own
    token-by-token decode of the same prompt: the logits at each chunk's
    last token and the states after the prompt."""
    cfg, bundle, params = _port(arch, "ref")
    n, c = 12, 4
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, n)).astype(np.int32))
    with torch.no_grad():
        step_cache = bundle.cache_init(1, 16)
        steps = []
        for t in range(n):
            logits, step_cache = bundle.decode_step(
                params, step_cache, tok[:, t],
                torch.full((1,), t, dtype=torch.int32))
            steps.append(logits)
        cache = bundle.cache_init(1, 16)
        chunks = []
        for t in range(0, n, c):
            logits, cache = bundle.prefill(
                params, cache, tok[:, t:t + c],
                torch.full((1,), t, dtype=torch.int32),
                torch.full((1,), c, dtype=torch.int32))
            chunks.append(logits)
    a, b = torch.stack(chunks), torch.stack(steps[c - 1::c])
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=STEP_TOL,
                               atol=STEP_TOL)
    assert torch.equal(a.argmax(-1), b.argmax(-1))
    for seg, ref in zip(cache, step_cache):
        mine, want = _leaves(seg), _leaves(ref)
        for k, v in mine.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=k)


# -- serving ------------------------------------------------------------------


def _prompts(vocab):
    return [np.random.default_rng(n).integers(0, vocab, size=n)
            for n in (1, 5, 9, 18, 3)]


def _serve(loop_cls, req_cls, cfg, bundle, params, **kw):
    loop = loop_cls(cfg, bundle, params, batch_slots=2, s_max=32, chunk=4,
                    **kw)
    return loop, loop.run([req_cls(rid=i, prompt=p, max_new=6)
                           for i, p in enumerate(_prompts(cfg.vocab))])


@pytest.mark.parametrize("jax_mode,mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_streams_match_jax(arch, jax_mode, mode):
    """``ServeLoop`` and ``PagedServeLoop`` (the contiguous fallback)
    serve JAX's streams token for token; the fallback pages nothing."""
    jcfg, jbundle, jparams, _ = _jax(arch, jax_mode)
    cfg, bundle, params = _port(arch, mode)
    jloop, want_p = _serve(JaxPagedServeLoop, JaxRequest, jcfg, jbundle,
                           jparams, page=8)
    _, want_c = _serve(JaxServeLoop, JaxRequest, jcfg, jbundle, jparams)
    loop, got_p = _serve(PagedServeLoop, Request, cfg, bundle, params,
                         page=8)
    _, got_c = _serve(ServeLoop, Request, cfg, bundle, params)
    assert got_c == want_c
    assert got_p == want_p == got_c
    assert sum(len(v) for v in got_p.values()) == 30
    assert loop.paged is False and jloop.paged is False
    assert loop.page_stats() == {"paged": False} == jloop.page_stats()
    assert loop.stats.page_allocs == 0 and loop.stats.prefix_hits == 0


@pytest.mark.parametrize("jax_mode,mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_legacy_one_slot_streams_match_jax(arch, jax_mode, mode):
    """The coupled loop at one slot, one request from a fresh cache:
    JAX's stream, and the decoupled loop's."""
    jcfg, jbundle, jparams, _ = _jax(arch, jax_mode)
    cfg, bundle, params = _port(arch, mode)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, size=11)
    want = JaxLegacyServeLoop(jcfg, jbundle, jparams, batch_slots=1,
                              s_max=24).run(
        [JaxRequest(rid=0, prompt=prompt, max_new=6)])
    got = LegacyServeLoop(cfg, bundle, params, batch_slots=1, s_max=24).run(
        [Request(rid=0, prompt=prompt, max_new=6)])
    decoupled = ServeLoop(cfg, bundle, params, batch_slots=1, s_max=24,
                          chunk=4).run([Request(rid=0, prompt=prompt,
                                                max_new=6)])
    assert got == want == decoupled


@pytest.mark.parametrize("loop_cls", [ServeLoop, PagedServeLoop])
@pytest.mark.parametrize("arch", ARCHS)
def test_slot_reuse_starts_from_zero_state(arch, loop_cls):
    """A slot recycled after a finish serves its next request as a fresh
    loop does: ``cache_reset`` zeroes the recurrent states, not only the
    attention leaves."""
    cfg, bundle, params = _port(arch, "kernel")
    first, second = _prompts(cfg.vocab)[3], _prompts(cfg.vocab)[2]
    reused = loop_cls(cfg, bundle, params, batch_slots=1, s_max=32,
                      chunk=4).run([Request(rid=0, prompt=first, max_new=5),
                                    Request(rid=1, prompt=second,
                                            max_new=5)])
    fresh = loop_cls(cfg, bundle, params, batch_slots=1, s_max=32,
                     chunk=4).run([Request(rid=1, prompt=second, max_new=5)])
    assert reused[1] == fresh[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_reset_zeroes_every_leaf(arch):
    cfg, bundle, params = _port(arch, "ref")
    cache = bundle.cache_init(3, 8)
    for leaf in _leaves({str(i): s for i, s in enumerate(cache)}).values():
        leaf.fill_(1)
    bundle.cache_reset(cache, torch.tensor([True, False, True]))
    for k, leaf in _leaves({str(i): s for i, s in enumerate(cache)}).items():
        assert bool((leaf[:, 1] == 0).all()), k
        assert bool((leaf[:, [0, 2]] == 1).all()), k


def test_window_served_past_the_window_follows_jax():
    """A finding of the reference, recorded, not fixed: JAX serves Hymba
    without its sliding window (the decode and the chunked fill attend
    the whole cache), while its cache-free forward applies it.  Past the
    window (32 at the smoke size) the served logits part from ``apply``'s;
    before it they agree.  The port equals JAX on each path."""
    jcfg, jbundle, jparams, _ = _jax(HYMBA, "ref")
    cfg, bundle, params = _port(HYMBA, "ref")
    n = cfg.window + 16
    tok = np.random.default_rng(8).integers(0, cfg.vocab, (1, n)).astype(
        np.int32)
    japply = np.asarray(jbundle.apply(jparams, _j(tok)))[0]
    jcache = jbundle.cache_init(1, n)
    jdecode = jax.jit(jbundle.decode_step)
    served = []
    for t in range(n):
        logits, jcache = jdecode(jparams, jcache, _j(tok[:, t]),
                                 jnp.full((1,), t, jnp.int32))
        served.append(np.asarray(logits)[0])
    jserved = np.stack(served)
    err = np.abs(jserved - japply).max(-1)
    assert err[:cfg.window].max() <= ATOL
    assert err[cfg.window:].min() > 100 * ATOL

    with torch.no_grad():
        papply = bundle.apply(params, _t(tok))[0]
        cache = bundle.cache_init(1, n)
        served = []
        for t in range(n):
            logits, cache = bundle.decode_step(
                params, cache, _t(tok[:, t]),
                torch.full((1,), t, dtype=torch.int32))
            served.append(logits[0])
    _close(papply, japply, ATOL)
    _close(torch.stack(served), jserved, ATOL)


# -- training -----------------------------------------------------------------


S = 16


def _batch(vocab):
    return SyntheticLM(vocab=vocab, seq_len=S, global_batch=B,
                       seed=3).batch_at(0)


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(arch):
    jcfg = jax_get_config(arch, smoke=True)
    jbundle = jax_build_model(jcfg)
    jparams = _weights(arch)[0]
    jbatch = JaxSyntheticLM(vocab=jcfg.vocab, seq_len=S, global_batch=B,
                            seed=3).batch_at(0)
    return jcfg, jbundle, jparams, jbatch, jax.jit(
        jax.value_and_grad(jbundle.loss))(
        jparams, {k: jnp.asarray(v) for k, v in jbatch.items()})


def _train_port(arch):
    cfg = get_config(arch, smoke=True, kernel_mode="ref")
    return cfg, params_from_numpy(cfg, _weights(arch)[1], device="cpu",
                                  dtype=cfg.pdtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    _, _, _, _, (jloss, jgrads) = _jax_loss_grads(arch)
    cfg, params = _train_port(arch)
    bundle = build_model(cfg, device="cpu")
    params.requires_grad_(True)
    loss = bundle.loss(params, {k: torch.from_numpy(v)
                                for k, v in _batch(cfg.vocab).items()})
    loss.backward()
    grads = params_to_numpy({k: p.grad for k, p in params.named_parameters()})
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    assert len(got) == len(want)
    for path, w in want:
        g, w = got[path], np.asarray(w)
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale, (jax.tree_util.keystr(path), err,
                                         scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One ``make_train_step`` AdamW step against JAX's loss, gradient
    norm and updated parameters from the same gradients."""
    jcfg, _, jparams, _, (jloss, jgrads) = _jax_loss_grads(arch)
    jopt = JaxAdamW(lr=1e-3)
    jnew, _, jnorm = jax.jit(jopt.update)(jgrads, jopt.init(jparams),
                                           jparams)
    cfg, params = _train_port(arch)
    opt = AdamW(lr=1e-3)
    params, _, metrics = make_train_step(cfg, opt, device="cpu")(
        params, opt.init(params), _batch(cfg.vocab))
    assert abs(float(metrics["loss"]) - float(jloss)) <= \
        LOSS_RTOL * abs(float(jloss))
    assert abs(float(metrics["grad_norm"]) - float(jnorm)) <= \
        GNORM_RTOL * abs(float(jnorm))
    got = dict(jax.tree_util.tree_flatten_with_path(params_to_numpy(params))
               [0])
    grads = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    held = total = 0
    for path, w in jax.tree_util.tree_flatten_with_path(jnew)[0]:
        g = np.abs(np.asarray(grads[path]))
        clear = g > max(10 * GRAD_TOL * float(g.max()), 100 * jopt.eps)
        held, total = held + int(clear.sum()), total + g.size
        np.testing.assert_allclose(got[path][clear], np.asarray(w)[clear],
                                   rtol=0, atol=UPDATE_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert held > total // 2
