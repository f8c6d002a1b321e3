"""Parity of the port's ``attn_impl`` variants with the JAX package's, on
the CPU: ``attention_chunked`` (online softmax over KV chunks) and
``attention_banded`` (sliding-window self-attention over the band only)
against JAX's ``ref.py`` on the same seeded inputs, within 1e-5 (float32
sums in different orders); ``_prefill_attention``'s dispatch in ``ref``
mode; and the cache-free forward of the smoke models with each
``attn_impl`` against JAX's within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention import ref as jref
from repro.models import attention as ja
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ref as tref
from repro_torch.models import attention as ta
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_numpy

ATOL = 1e-5


def _qkv(b, h, kvh, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, kvh, s, d)).astype(np.float32),
            rng.standard_normal((b, kvh, s, d)).astype(np.float32))


def _both(fn_j, fn_t, arrays, **kw):
    want = fn_j(*map(jnp.asarray, arrays), **kw)
    got = fn_t(*map(torch.from_numpy, arrays), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    return got


# (H, KVH, S, D, causal, window, chunk): chunks that divide S, that do not
# (the largest divisor below is taken), above S, GQA groups, windows
# shorter than a chunk and longer than S
CHUNKED = [(4, 4, 32, 16, True, None, 8),
           (4, 2, 30, 16, True, None, 8),
           (6, 2, 17, 32, True, 5, 4),
           (4, 1, 24, 16, False, None, 64),
           (4, 2, 40, 16, True, 64, 16),
           (2, 2, 9, 8, False, 3, 3)]


@pytest.mark.parametrize("h,kvh,s,d,causal,window,chunk", CHUNKED)
def test_attention_chunked_matches_jax(h, kvh, s, d, causal, window, chunk):
    got = _both(jref.attention_chunked, tref.attention_chunked,
                _qkv(2, h, kvh, s, d), causal=causal, window=window,
                chunk=chunk)
    want = tref.attention_ref(*map(torch.from_numpy, _qkv(2, h, kvh, s, d)),
                              causal=causal, window=window)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


# (H, KVH, S, D, window, chunk)
BANDED = [(4, 4, 32, 16, 8, 8),
          (4, 2, 30, 16, 6, 8),
          (6, 2, 17, 32, 5, 4),
          (4, 1, 24, 16, 32, 6),
          (2, 2, 12, 8, 1, 12)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh,s,d,window,chunk", BANDED)
def test_attention_banded_matches_jax(h, kvh, s, d, window, chunk, causal):
    got = _both(jref.attention_banded, tref.attention_banded,
                _qkv(2, h, kvh, s, d, seed=1), window=window, causal=causal,
                chunk=chunk)
    if causal:
        want = tref.attention_ref(
            *map(torch.from_numpy, _qkv(2, h, kvh, s, d, seed=1)),
            causal=True, window=window)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("impl,window,chunk", [
    ("ref", None, 1024), ("chunked", None, 8), ("chunked", 6, 8),
    ("banded", 6, 4), ("banded", None, 8), ("banded", 12, 64)])
def test_prefill_attention_dispatch_matches_jax(impl, window, chunk):
    over = dict(kernel_mode="ref", attn_impl=impl, attn_chunk=chunk)
    jcfg = jax_get_config("qwen3-4b", smoke=True, **over)
    cfg = get_config("qwen3-4b", smoke=True, **over)
    arrays = _qkv(2, 4, 2, 24, 16, seed=2)
    want = ja._prefill_attention(jcfg, *map(jnp.asarray, arrays),
                                 causal=True, window=window)
    got = ta._prefill_attention(cfg, *map(torch.from_numpy, arrays),
                                window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ["qwen3-4b", "minicpm3-4b"])
@pytest.mark.parametrize("impl", ["chunked", "banded"])
def test_cache_free_forward_with_attn_impl_matches_jax(arch, impl):
    # a sliding window of 8 (MLA takes none, in both packages)
    over = dict(kernel_mode="ref", attn_impl=impl, attn_chunk=8, window=8)
    jcfg = jax_get_config(arch, smoke=True, **over)
    cfg = get_config(arch, smoke=True, **over)
    jparams = jt.lm_init(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (2, 20)).astype(
        np.int32)
    want = jt.lm_apply(jcfg, jparams, jnp.asarray(tok))
    got = tt.lm_apply(cfg, params, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    plain = tt.lm_apply(dataclasses.replace(cfg, attn_impl="ref"), params,
                        torch.from_numpy(tok))
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-4)
