"""Parity of the port's encoder-decoder (seamless-m4t-large-v2, family
``encdec``: ``models/encdec.py``, the ``enc`` and ``xattn`` blocks,
``cross_kv`` and ``cross_attn_apply``, the registry's encdec bundle,
``make_prefill_step``/``make_serve_step`` and serving with
``Request.frames``) with the JAX package's, on the CPU.

The smoke configuration (2 encoder and 2 decoder layers, d_model 64, 4
heads over 2 KV heads, relu MLP, float32) with JAX's random weights
moved over by ``params_from_numpy``.  JAX runs in ``kernel_mode="ref"``
(one encoder case in ``"pallas"``, interpret mode); the port in both of
its modes (``"kernel"`` takes the kernels' plain versions on CPU
tensors).  The cross attention's bias cases override ``qkv_bias=True``
in both packages and carry nonzero random biases across.

Tolerances, float32 throughout: 1e-5 for the encoder output, the cross
attention, the logits and the caches (sums in other orders); the
port's chunked fill against its own token-by-token decode: bit for
bit; loss within 1e-6 relative of JAX's ``value_and_grad``, each
gradient leaf within 1e-5 of its largest |g|; token streams equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models import attention as jattn
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serve_loop import Request as JaxRequest
from repro.runtime.serve_loop import ServeLoop as JaxServeLoop
from repro_torch.configs import get_config
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import attention as attn
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime.serve_loop import PagedServeLoop, Request, ServeLoop

ARCH = "seamless-m4t-large-v2"
MODES = ["kernel", "ref"]
ATOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5          # of each leaf's largest |g|
B = 2


def _with_biases(tree, seed):
    """``tree`` (JAX's numpy parameters) with every ``bq``/``bk``/``bv``
    leaf drawn N(0, 0.5): JAX initialises them to zeros, which would
    hide a missing add."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (rng.normal(0, 0.5, v.shape).astype(v.dtype)
                        if k in ("bq", "bk", "bv") else walk(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(tree)


@functools.lru_cache(maxsize=None)
def _weights(bias=False):
    cfg = jax_get_config(ARCH, smoke=True, qkv_bias=bias)
    params = jax.jit(jax_build_model(cfg).init)(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    if bias:
        tree = _with_biases(tree, 1)
        params = jax.tree.map(jnp.asarray, tree)
    return params, tree


@functools.lru_cache(maxsize=None)
def _jax(mode="ref", bias=False):
    cfg = jax_get_config(ARCH, smoke=True, kernel_mode=mode, qkv_bias=bias)
    return (cfg, jax_build_model(cfg)) + _weights(bias)


@functools.lru_cache(maxsize=None)
def _port(mode, bias=False):
    cfg = get_config(ARCH, smoke=True, kernel_mode=mode, qkv_bias=bias)
    return (cfg, build_model(cfg, device="cpu"),
            params_from_numpy(cfg, _weights(bias)[1], device="cpu"))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _frames(b, s, d, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# -- structure ----------------------------------------------------------------


@pytest.mark.parametrize("bias", [False, True])
def test_parameters_carry_jax_tree(bias):
    """Every leaf of JAX's ``encdec_init`` tree (``embed``, ``enc/...``,
    ``enc_norm``, ``dec/{attn,xattn,mlp,ln1,lnx,ln2}/...``,
    ``final_norm``, ``unembed``) lands in the port and comes back
    unchanged."""
    _, tree = _weights(bias)
    cfg, _, params = _port("ref", bias)
    back = params_to_numpy(params)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(got[path], w,
                                      err_msg=jax.tree_util.keystr(path))
    assert set(tree["dec"]) == {"attn", "xattn", "mlp", "ln1", "lnx", "ln2"}
    assert tree["enc"]["attn"]["wq"].shape[0] == cfg.n_enc_layers
    if bias:
        assert float(np.abs(tree["dec"]["xattn"]["bk"]).max()) > 0


def test_bundle_is_the_encdec_one():
    _, bundle, _ = _port("kernel")
    assert bundle.apply is None and bundle.encode is not None
    assert bundle.cache_init_paged is None and bundle.prefill_paged is None
    assert bundle.copy_pages is None and bundle.cache_reset_paged is None


# -- the encoder and the cross attention --------------------------------------


@pytest.mark.parametrize("s_enc,mode,jax_mode", [
    (8, "kernel", "ref"), (8, "ref", "ref"), (13, "kernel", "ref"),
    (13, "ref", "ref"), (8, "kernel", "pallas"), (8, "ref", "pallas")])
def test_encode_matches_jax(s_enc, mode, jax_mode):
    """The bidirectional encoder on 8 frames and on a length that is not
    a multiple of 8; JAX's ``pallas`` mode (interpret) at 8 only."""
    _, jbundle, jparams, _ = _jax(jax_mode)
    cfg, bundle, params = _port(mode)
    fr = _frames(B, s_enc, cfg.d_model, seed=s_enc)
    want = jbundle.encode(jparams, jnp.asarray(fr))
    with torch.no_grad():
        got = bundle.encode(params, _t(fr))
    assert tuple(got.shape) == (B, s_enc, cfg.d_model)
    _close(got, want)


def test_encoder_is_bidirectional():
    """Changing the last frame moves the encoder output at the first
    position (a causal encoder would not)."""
    cfg, bundle, params = _port("kernel")
    fr = _frames(1, 8, cfg.d_model)
    fr2 = fr.copy()
    fr2[0, -1] += 1.0
    with torch.no_grad():
        a = bundle.encode(params, _t(fr))
        b = bundle.encode(params, _t(fr2))
    assert float((a[0, 0] - b[0, 0]).abs().max()) > 1e-4


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_cross_kv_and_cross_attention_match_jax(mode, bias, per_query):
    jcfg, _, jparams, _ = _jax("ref", bias)
    cfg, _, params = _port(mode, bias)
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((B, 11, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["dec"])["xattn"]
    jk, jv = jattn.cross_kv(jcfg, jp, jnp.asarray(enc))
    want = jattn.cross_attn_apply(jcfg, jp, jnp.asarray(x), (jk, jv),
                                  None, per_query=per_query)
    p = params.dec[1].xattn
    with torch.no_grad():
        k, v = attn.cross_kv(cfg, p, _t(enc))
        got = attn.cross_attn_apply(cfg, p, _t(x), (k, v),
                                    per_query=per_query)
    _close(k, jk)
    _close(v, jv)
    _close(got, want)


def test_per_query_cross_attention_equals_single_queries_bit_for_bit():
    """``per_query`` computes what one-query calls compute."""
    cfg, _, params = _port("kernel", True)
    rng = np.random.default_rng(4)
    enc = _t(rng.standard_normal((B, 9, cfg.d_model)).astype(np.float32))
    x = _t(rng.standard_normal((B, 4, cfg.d_model)).astype(np.float32))
    p = params.dec[0].xattn
    with torch.no_grad():
        kv = attn.cross_kv(cfg, p, enc)
        chunk = attn.cross_attn_apply(cfg, p, x, kv, per_query=True)
        ones = [attn.cross_attn_apply(cfg, p, x[:, i:i + 1].contiguous(), kv)
                for i in range(x.shape[1])]
    assert torch.equal(chunk, torch.cat(ones, 1))


# -- decoding -----------------------------------------------------------------


STEPS = [(4, (4, 2)), (4, (0, 3)), (1, (1, 1)), (1, (1, 0))]


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_jax(mode):
    """Chunked fills with invalid tokens (a row with none), masked
    single-token steps, then the unmasked ``decode_step``: logits and
    every cache leaf equal JAX's."""
    _, jbundle, jparams, _ = _jax()
    cfg, bundle, params = _port(mode)
    fr = _frames(B, 10, cfg.d_model, seed=5)
    jenc = jbundle.encode(jparams, jnp.asarray(fr))
    jcache = jbundle.cache_init(B, 16)
    cache = bundle.cache_init(B, 16)
    rng = np.random.default_rng(0)
    pos = np.zeros(B, np.int32)
    with torch.no_grad():
        enc = bundle.encode(params, _t(fr))
        for width, n_valid in STEPS:
            tok = rng.integers(0, cfg.vocab, (B, width)).astype(np.int32)
            n_valid = np.asarray(n_valid, np.int32)
            want, jcache = jbundle.prefill(jparams, jenc, jcache,
                                           jnp.asarray(tok),
                                           jnp.asarray(pos),
                                           jnp.asarray(n_valid))
            got, cache = bundle.prefill(params, enc, cache, _t(tok),
                                        _t(pos), _t(n_valid))
            _close(got, want)
            pos += n_valid
        tok = np.array([5, 9], np.int32)
        want, jcache = jbundle.decode_step(jparams, jenc, jcache,
                                           jnp.asarray(tok),
                                           jnp.asarray(pos))
        got, cache = bundle.decode_step(params, enc, cache, _t(tok), _t(pos))
    _close(got, want)
    mine, ref = _leaves(cache), _leaves(jcache)
    assert set(mine) == set(ref) == {"attn/k", "attn/v", "attn/len"}
    for k, v in mine.items():
        if k.endswith("len"):
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))
        else:
            _close(v, ref[k])


@pytest.mark.parametrize("mode", MODES)
def test_chunked_fill_equals_stepwise_decode_bit_for_bit(mode):
    """Chunks of 4 against the same 10 tokens decoded one at a time:
    the logits at each chunk's last token and the caches after."""
    cfg, bundle, params = _port(mode)
    n, c = 10, 4
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (B, n)).astype(np.int32))
    with torch.no_grad():
        enc = bundle.encode(params, _t(_frames(B, 8, cfg.d_model, seed=6)))
        step_cache = bundle.cache_init(B, 16)
        steps = []
        for t in range(n):
            logits, step_cache = bundle.decode_step(
                params, enc, step_cache, tok[:, t],
                torch.full((B,), t, dtype=torch.int32))
            steps.append(logits)
        cache = bundle.cache_init(B, 16)
        chunks = []
        for t in range(0, n, c):
            w = min(c, n - t)
            chunk = torch.zeros((B, c), dtype=torch.int32)
            chunk[:, :w] = tok[:, t:t + w]
            logits, cache = bundle.prefill(
                params, enc, cache, chunk,
                torch.full((B,), t, dtype=torch.int32),
                torch.full((B,), w, dtype=torch.int32))
            chunks.append(logits)
    for i, t in enumerate(range(0, n, c)):
        assert torch.equal(chunks[i], steps[min(t + c, n) - 1]), t
    for k, v in _leaves(cache).items():
        assert torch.equal(v, _leaves(step_cache)[k]), k


def test_steps_match_jax():
    """``make_prefill_step`` returns the encoder output; ``make_serve_step``
    (``enc_out`` last) one decode step, as JAX's."""
    jcfg, jbundle, jparams, _ = _jax()
    cfg, bundle, params = _port("kernel")
    fr = _frames(B, 8, cfg.d_model, seed=7)
    enc = make_prefill_step(cfg, "cpu")(params, {"frames": _t(fr)})
    jenc = jbundle.encode(jparams, jnp.asarray(fr))
    _close(enc, jenc)
    tok, pos = np.array([3, 4], np.int32), np.zeros(B, np.int32)
    want, _ = jax_make_serve_step(jcfg)(jparams, jbundle.cache_init(B, 8),
                                        jnp.asarray(tok), jnp.asarray(pos),
                                        jenc)
    got, cache = make_serve_step(cfg, "cpu")(params, bundle.cache_init(B, 8),
                                             _t(tok), _t(pos), enc)
    _close(got, want)
    assert cache["attn"]["len"].tolist() == [[1, 1]] * cfg.n_layers


# -- training -----------------------------------------------------------------


def _train_batch(vocab, d):
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, vocab, (B, 12)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    labels[:, -1] = -1
    return {"frames": _frames(B, 8, d, seed=8), "tokens": tokens,
            "labels": labels}


@functools.lru_cache(maxsize=None)
def _jax_loss_grads():
    jcfg = jax_get_config(ARCH, smoke=True)
    batch = _train_batch(jcfg.vocab, jcfg.d_model)
    return batch, jax.jit(jax.value_and_grad(jax_build_model(jcfg).loss))(
        _weights()[0], {k: jnp.asarray(v) for k, v in batch.items()})


def test_loss_and_grads_match_jax():
    batch, (jloss, jgrads) = _jax_loss_grads()
    cfg = get_config(ARCH, smoke=True, kernel_mode="ref")
    params = params_from_numpy(cfg, _weights()[1], device="cpu",
                               dtype=cfg.pdtype)
    params.requires_grad_(True)
    loss = build_model(cfg, device="cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    grads = params_to_numpy({k: p.grad for k, p in params.named_parameters()})
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    assert len(got) == len(want)
    for path, w in want:
        g, w = got[path], np.asarray(w)
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= GRAD_TOL * scale, \
            jax.tree_util.keystr(path)


def test_train_step_takes_the_encdec_loss():
    batch, (jloss, _) = _jax_loss_grads()
    cfg = get_config(ARCH, smoke=True, kernel_mode="ref")
    params = params_from_numpy(cfg, _weights()[1], device="cpu",
                               dtype=cfg.pdtype)
    before = params.dec[0].xattn.wq.detach().clone()
    opt = AdamW(lr=1e-3)
    params, _, metrics = make_train_step(cfg, opt, device="cpu")(
        params, opt.init(params), batch)
    assert abs(float(metrics["loss"]) - float(jloss)) <= \
        LOSS_RTOL * abs(float(jloss))
    assert not torch.equal(params.dec[0].xattn.wq, before)


# -- serving ------------------------------------------------------------------


def _requests(req_cls, d, n_enc=8):
    """JAX's ``test_serve_encdec_end_to_end`` requests (frames of 8,
    prompts of 4 and 6 tokens), then three more so that slots recycle."""
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((5, n_enc, d)).astype(np.float32)
    prompts = [np.random.default_rng(s).integers(0, 512, size=n)
               for s, n in ((12, 4), (13, 6), (14, 1), (15, 9), (16, 3))]
    return [req_cls(rid=i, prompt=p, max_new=3 + i % 2, frames=fr)
            for i, (p, fr) in enumerate(zip(prompts, frames))]


@functools.lru_cache(maxsize=None)
def _jax_streams():
    jcfg, jbundle, jparams, _ = _jax()
    loop = JaxServeLoop(jcfg, jbundle, jparams, batch_slots=2, s_max=32,
                        chunk=4)
    return loop.run(_requests(JaxRequest, jcfg.d_model))


@pytest.mark.parametrize("loop_cls", [ServeLoop, PagedServeLoop])
@pytest.mark.parametrize("mode", MODES)
def test_serve_streams_match_jax(mode, loop_cls):
    """Both loops serve JAX's ``ServeLoop`` streams token for token;
    ``PagedServeLoop`` falls back to the contiguous path and pages
    nothing."""
    cfg, bundle, params = _port(mode)
    loop = loop_cls(cfg, bundle, params, batch_slots=2, s_max=32, chunk=4)
    got = loop.run(_requests(Request, cfg.d_model))
    assert got == _jax_streams()
    assert sum(map(len, got.values())) == 17
    assert tuple(loop.enc_out.shape) == (2, 8, cfg.d_model)
    if loop_cls is PagedServeLoop:
        assert loop.paged is False and loop.page_stats() == {"paged": False}
        assert loop.stats.page_allocs == 0


@pytest.mark.parametrize("loop_cls", [ServeLoop, PagedServeLoop])
def test_request_without_frames_raises(loop_cls):
    cfg, bundle, params = _port("kernel")
    reqs = _requests(Request, cfg.d_model)
    reqs[2] = dataclasses.replace(reqs[2], frames=None)
    loop = loop_cls(cfg, bundle, params, batch_slots=2, s_max=32, chunk=4)
    with pytest.raises(ValueError, match="requires Request.frames"):
        loop.run(reqs)
    assert loop.stats.admitted == 0     # rejected before any admission


@pytest.mark.parametrize("loop_cls", [ServeLoop, PagedServeLoop])
def test_frames_of_another_length_raise(loop_cls):
    cfg, bundle, params = _port("kernel")
    reqs = _requests(Request, cfg.d_model)
    reqs[3] = dataclasses.replace(reqs[3], frames=reqs[3].frames[:5])
    loop = loop_cls(cfg, bundle, params, batch_slots=2, s_max=32, chunk=4)
    with pytest.raises(ValueError, match="one fixed encoder length"):
        loop.run(reqs)


@pytest.mark.parametrize("loop_cls", [ServeLoop, PagedServeLoop])
def test_recycled_slot_gets_its_new_encoding(loop_cls):
    """One slot serving two requests with different frames: the second
    is served as a fresh loop serves it alone, and the buffer holds its
    encoding after."""
    cfg, bundle, params = _port("kernel")
    first, second = _requests(Request, cfg.d_model)[3:5]
    reused = loop_cls(cfg, bundle, params, batch_slots=1, s_max=32, chunk=4)
    got = reused.run([first, dataclasses.replace(second, out=None)])
    fresh = loop_cls(cfg, bundle, params, batch_slots=1, s_max=32,
                     chunk=4).run([dataclasses.replace(second, out=None)])
    assert got[second.rid] == fresh[second.rid]
    with torch.no_grad():
        want = bundle.encode(params, _t(second.frames[None]))
    assert torch.equal(reused.enc_out, want)


def test_cache_reset_zeroes_rows_and_leaves_the_encoding():
    cfg, bundle, params = _port("ref")
    cache = bundle.cache_init(3, 8)
    for leaf in _leaves(cache).values():
        leaf.fill_(1)
    bundle.cache_reset(cache, torch.tensor([True, False, True]))
    for k, leaf in _leaves(cache).items():
        assert bool((leaf[:, 1] == 0).all()), k
        assert bool((leaf[:, [0, 2]] == 1).all()), k
