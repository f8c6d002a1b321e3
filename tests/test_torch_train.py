"""Parity of the port's training path with the JAX package's, on the CPU.

For the five model families the port has (qwen3-4b dense GQA,
granite-moe-3b-a800m MoE, minicpm3-4b MLA, deepseek-v2-lite-16b MLA +
MoE, granite-34b MQA) at their smoke configurations (float32,
``kernel_mode="ref"``), with JAX's random weights moved over by
``params_from_numpy`` into float32 storage and one ``SyntheticLM``
batch: the loss of ``ModelBundle.loss`` within 1e-5 relative of JAX's
``bundle.loss``, and every gradient leaf, stacked into JAX's layout by
``params_to_numpy``, within 1e-4 of that leaf's largest |g| (float32
sums in other orders through a few layers and a remat'd backward).
``moe_aux_loss`` within 1e-6 of JAX's.  Rematerialisation ("full" and
"dots") leaves the gradients bit-equal to none.  A ``kernel``-mode train
step raises ``NotImplementedError`` as JAX's ``pallas`` one does.
Serving is unchanged by the storage argument: float32 storage and
serving's bfloat16 storage give bit-equal kernel-mode logits.  Last, the
capacity drop the two packages resolve differently: JAX writes each
dropped pair onto its expert's slot 0 and loses that slot's token; the
port keeps it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import moe as jmoe
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamW

ARCHS = ["qwen3-4b", "granite-moe-3b-a800m", "minicpm3-4b",
         "deepseek-v2-lite-16b", "granite-34b"]
MOE_ARCHS = ["granite-moe-3b-a800m", "deepseek-v2-lite-16b"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest |g|
AUX_TOL = 1e-6
B, S = 2, 16

_CACHE = {}


def _jax(arch):
    """JAX's smoke config, bundle, weights and their numpy tree."""
    if arch not in _CACHE:
        cfg = jax_get_config(arch, smoke=True)
        bundle = jax_build_model(cfg)
        params = jax.jit(bundle.init)(jax.random.PRNGKey(0))
        _CACHE[arch] = (cfg, bundle, params, jax.tree.map(np.asarray, params))
    return _CACHE[arch]


def _port(arch, **overrides):
    cfg = get_config(arch, smoke=True, kernel_mode="ref", **overrides)
    params = params_from_numpy(cfg, _jax(arch)[3], device="cpu",
                               dtype=cfg.pdtype)
    return cfg, build_model(cfg, device="cpu"), params


def _batch(vocab):
    return SyntheticLM(vocab=vocab, seq_len=S, global_batch=B,
                       seed=3).batch_at(0)


def _port_grads(bundle, params, batch):
    params.requires_grad_(True)
    loss = bundle.loss(params, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    loss.backward()
    grads = {k: p.grad for k, p in params.named_parameters()}
    return float(loss.detach()), params_to_numpy(grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, jbundle, jparams, _ = _jax(arch)
    batch = _batch(jcfg.vocab)
    jbatch = JaxSyntheticLM(vocab=jcfg.vocab, seq_len=S, global_batch=B,
                            seed=3).batch_at(0)
    jloss, jgrads = jax.jit(jax.value_and_grad(jbundle.loss))(
        jparams, {k: jnp.asarray(v) for k, v in jbatch.items()})
    _, bundle, params = _port(arch)
    loss, grads = _port_grads(bundle, params, batch)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_aux_loss_matches_jax(arch):
    jcfg, _, _, tree = _jax(arch)
    cfg, _, params = _port(arch)
    seg = len(cfg.layer_specs()) - 1            # the MoE segment
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], tree["segments"][seg]["moe"])
    want = float(jmoe.moe_aux_loss(jcfg, jp, jnp.asarray(x)))
    got = float(moe.moe_aux_loss(cfg, params.segments[seg][0].moe,
                                 torch.from_numpy(x)))
    assert abs(got - want) <= AUX_TOL * max(abs(want), 1.0)
    assert got > 0.0


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m",
                                  "minicpm3-4b"])
def test_remat_gradients_bit_equal(arch, policy):
    jcfg = _jax(arch)[0]
    batch = _batch(jcfg.vocab)
    _, bundle, params = _port(arch, remat=False)
    loss0, g0 = _port_grads(bundle, params, batch)
    _, bundle, params = _port(arch, remat=True, remat_policy=policy)
    loss1, g1 = _port_grads(bundle, params, batch)
    assert loss0 == loss1
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(g0)[0],
                                 jax.tree_util.tree_flatten_with_path(g1)[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_remat_policy_is_checked():
    with pytest.raises(ValueError, match="remat_policy"):
        get_config("qwen3-4b", smoke=True, remat_policy="offload")


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m"])
def test_kernel_mode_train_step_raises(arch):
    """JAX's ``pallas`` mode raises under ``value_and_grad``; so does the
    port's ``kernel`` mode, at its first dispatcher (the gather), without
    switching modes, leaving no gradient and the optimizer untouched."""
    jcfg, _, jparams, tree = _jax(arch)
    batch = _batch(jcfg.vocab)
    jpallas = jax_build_model(dataclasses.replace(jcfg,
                                                  kernel_mode="pallas"))
    with pytest.raises(NotImplementedError):
        jax.value_and_grad(jpallas.loss)(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = get_config(arch, smoke=True, kernel_mode="kernel")
    params = params_from_numpy(cfg, tree, device="cpu", dtype=cfg.pdtype)
    step = make_train_step(cfg, AdamW(), device="cpu")
    opt = AdamW().init(params)
    with pytest.raises(NotImplementedError, match="kernel_mode='ref'"):
        step(params, opt, batch)
    assert all(p.grad is None for p in params.parameters())
    assert int(opt.step) == 0


def test_train_step_refuses_low_precision_storage():
    cfg = get_config("qwen3-4b", smoke=True, kernel_mode="ref",
                     dtype="bfloat16")
    params = params_from_numpy(cfg, _jax("qwen3-4b")[3], device="cpu")
    step = make_train_step(cfg, AdamW(), device="cpu")
    with pytest.raises(ValueError, match="dtype=cfg.pdtype"):
        step(params, AdamW().init(params), _batch(cfg.vocab))


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m"])
def test_serving_unchanged_by_storage(arch):
    """Serving's bfloat16 storage and float32 storage cast to bfloat16 at
    each use give bit-equal kernel-mode prefill logits (through the
    kernels' plain versions here; the card's launch counts are
    ``chip_smoke.py``'s); on bfloat16 storage every cast returns the
    stored tensor itself."""
    tree = _jax(arch)[3]
    cfg = get_config(arch, smoke=True, dtype="bfloat16")
    tok = torch.from_numpy(_batch(cfg.vocab)["tokens"])
    outs = []
    for dtype in (None, torch.float32):
        params = params_from_numpy(cfg, tree, device="cpu", dtype=dtype)
        outs.append(make_prefill_step(cfg, device="cpu")(params,
                                                         {"tokens": tok}))
        if dtype is None:
            wq = params.segments[0][0].attn.wq
            assert wq.dtype == torch.bfloat16
            assert wq.to(cfg.adtype) is wq
    assert torch.equal(outs[0], outs[1])


def test_moe_overflow_jax_loses_slot0_token():
    """Every token routed to experts 0 and 1, capacity 1: each expert
    keeps its first pair (token 0) and drops the rest.  JAX also writes
    every dropped pair's pad entry onto slot 0, where the last write
    wins on the CPU, so token 0's row comes back zero; the port writes
    only kept pairs and token 0 keeps its experts' output, equal to the
    dropless output's row 0.  Tokens 1.. are dropped by both."""
    arch = "granite-moe-3b-a800m"
    jcfg, _, _, tree = _jax(arch)
    cfg, _, params = _port(arch)
    p = params.segments[0][0].moe
    jp = jax.tree.map(lambda a: np.array(a[0]), tree["segments"][0]["moe"])
    router = np.zeros_like(jp["router"])
    router[:, :2] = 1.0
    jp["router"] = router
    with torch.no_grad():
        p.router.copy_(torch.from_numpy(router))
    t = 8
    x = np.abs(np.random.default_rng(2).standard_normal(
        (1, t, cfg.d_model))).astype(np.float32)
    cf = cfg.n_experts / (t * cfg.top_k)            # capacity 1
    jy = np.asarray(jmoe.moe_apply(jcfg, jp, jnp.asarray(x),
                                   capacity_factor=cf))[0]
    with torch.no_grad():
        y = moe.moe_apply(cfg, p, torch.from_numpy(x),
                          capacity_factor=cf)[0].numpy()
        full = moe.moe_apply(cfg, p, torch.from_numpy(x),
                             capacity_factor=float(cfg.n_experts))[0].numpy()
    assert np.all(jy == 0.0)
    assert np.all(y[1:] == 0.0)
    assert np.abs(y[0]).max() > 0.1
    np.testing.assert_allclose(y[0], full[0], rtol=0, atol=1e-6)
