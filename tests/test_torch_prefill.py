"""Parity of the port's cache-free forward with the JAX package's, on the
CPU.

``flash_attention`` with the JAX side in interpret mode (its Pallas
``flash`` kernel) or its ``ref`` method, against the port's kernel
wrapper (its plain version on CPU tensors) or its oracle, on the same
numpy inputs: causal, sliding-window, non-causal, GQA, sequence lengths
that are not a multiple of the block, head dims 16 and 64, and MLA's 96
and 192.  Then
``lm_apply`` / ``ModelBundle.apply`` and ``make_prefill_step`` for the
smoke configurations of granite-moe-3b-a800m (MoE, tied embeddings) and
qwen3-4b (dense), with JAX's weights, in both mode pairs.

Tolerances: attention 1e-5 (float32 sums in different orders);
logits 1e-4 (as ``test_torch_model.py``: float32 through two layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import build_model

ATTN_ATOL = 1e-5
ATOL = 1e-4
MODES = [("pallas", "kernel"), ("ref", "ref")]
ARCHS = ["granite-moe-3b-a800m", "qwen3-4b"]
BLOCK = 16                       # the JAX kernel's bq = bk here

# (causal, window, H, KVH, S, D)
ATTN_CASES = {
    "causal": (True, None, 4, 4, 32, 16),
    "causal_gqa_ragged": (True, None, 6, 2, 37, 64),
    "window_gqa": (True, 8, 4, 2, 40, 16),
    "bidirectional_ragged": (False, None, 2, 1, 21, 64),
    # MLA's head dims dn + dr: minicpm3-4b's 96, deepseek-v2-lite-16b's 192
    "causal_gqa_d96": (True, None, 4, 2, 40, 96),
    "window_ragged_d96": (True, 8, 2, 2, 37, 96),
    "causal_ragged_d192": (True, None, 2, 1, 37, 192),
    "window_d192": (True, 8, 2, 2, 40, 192),
}

_JAX = {}


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("jax_method,method", MODES)
def test_flash_attention_matches_jax(case, jax_method, method):
    causal, window, h, kvh, s, d = ATTN_CASES[case]
    rng = np.random.default_rng(s * d)
    q = rng.standard_normal((2, h, s, d)).astype(np.float32)
    k = rng.standard_normal((2, kvh, s, d)).astype(np.float32)
    v = rng.standard_normal((2, kvh, s, d)).astype(np.float32)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, bq=BLOCK, bk=BLOCK, method=jax_method,
        interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                          method=method).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATTN_ATOL)


def test_flash_cpu_tensors_take_the_plain_version_and_meta_raises():
    q = torch.zeros(1, 2, 4, 16)
    before = fk.flash.launches
    fk.flash(q, q, q, causal=True, window=None, scale=0.25)
    assert fk.flash.launches == before
    meta = torch.zeros(1, 2, 4, 16, device="meta")
    with pytest.raises(ValueError):
        fk.flash(meta, meta, meta, causal=True, window=None, scale=0.25)


def _jax_model(arch, mode):
    key = arch, mode
    if key not in _JAX:
        cfg = jax_get_config(arch, smoke=True, kernel_mode=mode)
        params = jt.lm_init(cfg, jax.random.PRNGKey(0))
        _JAX[key] = (cfg, params, jax.tree.map(np.asarray, params))
    return _JAX[key]


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, (2, 12)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_lm_apply_matches_jax(arch, jax_mode, mode):
    jcfg, jparams, tree = _jax_model(arch, jax_mode)
    cfg = get_config(arch, smoke=True, kernel_mode=mode)
    bundle = build_model(cfg, device="cpu")
    params = params_from_numpy(cfg, tree, device="cpu")
    assert hasattr(params, "unembed") is not cfg.tie_embeddings
    tok = _tokens(cfg.vocab)
    want = np.asarray(jt.lm_apply(jcfg, jparams, jnp.asarray(tok)))
    got = bundle.apply(params, _t(tok))
    assert got.dtype == cfg.adtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("jax_mode,mode", MODES)
def test_make_prefill_step_matches_jax(arch, jax_mode, mode):
    jcfg, jparams, tree = _jax_model(arch, jax_mode)
    cfg = get_config(arch, smoke=True, kernel_mode=mode)
    params = params_from_numpy(cfg, tree, device="cpu")
    tok = _tokens(cfg.vocab)
    want = np.asarray(jax_make_prefill_step(jcfg)(
        jparams, {"tokens": jnp.asarray(tok)}))
    got = make_prefill_step(cfg, device="cpu")(params, {"tokens": _t(tok)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
