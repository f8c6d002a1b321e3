"""Parity of the port's coupled ``LegacyServeLoop`` with the JAX
package's, on the CPU.

The smoke models of qwen3-4b (GQA, G 2) and granite-34b (MQA, GELU MLP,
G 4), with JAX's random weights moved over by ``params_from_numpy``, in
both kernel modes (JAX's ``"pallas"`` in interpret mode against the
port's ``"kernel"``, which takes the kernels' plain versions on CPU
tensors; and ``"ref"``).  Token streams must be equal to JAX's:

  * at one slot, one request from a fresh cache (the regime where the
    coupled loop is correct), where they also equal the port's
    decoupled ``ServeLoop`` (``benchmarks/serve_bench.py::
    _parity_cell``);
  * at four slots under the serve bench's ``"mixed"`` mix (prompts of 4
    and 48 tokens alternating, 16 new each, s_max 128, as
    ``chip_smoke.py``'s legacy cell), where admission stalls and
    pollutes the other slots' caches and drives their lengths past s_max
    (writes there are dropped; attention reads the s_max written
    positions);
  * for an empty prompt (an implicit BOS) and ``max_new`` 0.

Past s_max the reference's two modes part where s_max is not a multiple
of its decode block (128): its ``pallas`` decode pads the cache to the
block with zeros and attends the padding up to each length, its ``ref``
decode does not.  At the serve bench's s_max 72 the port's streams, in
both modes, equal the reference's ``ref`` streams.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serve_loop import LegacyServeLoop as JaxLegacyServeLoop
from repro.runtime.serve_loop import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve_loop import (LegacyServeLoop, Request,
                                            ServeLoop)

ARCHS = ["qwen3-4b", "granite-34b"]
MODES = [("pallas", "kernel"), ("ref", "ref")]
MIXED = (4, 48)                 # benchmarks/serve_bench.py MIXES["mixed"]
MAX_NEW = 16
MIXED_S_MAX = 128
BENCH_S_MAX = max(MIXED) + MAX_NEW + 8      # the serve bench's s_max, 72


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = jax_get_config(arch, smoke=True)
    params = jax.jit(jax_build_model(cfg).init)(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax(arch, mode):
    cfg = jax_get_config(arch, smoke=True, kernel_mode=mode)
    return cfg, jax_build_model(cfg), _weights(arch)[0]


@functools.lru_cache(maxsize=None)
def _port(arch, mode):
    cfg = get_config(arch, smoke=True, kernel_mode=mode)
    return (cfg, build_model(cfg, device="cpu"),
            params_from_numpy(cfg, _weights(arch)[1], device="cpu"))


def _mixed_prompts(n, vocab, seed=0):
    """``benchmarks/serve_bench.py::_prompts("mixed", n, vocab)``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=MIXED[i % 2]) for i in range(n)]


def _both(arch, jax_mode, mode, prompts, slots, s_max, max_new):
    """(JAX's streams, the port's streams, the port's loop)."""
    jcfg, jbundle, jparams = _jax(arch, jax_mode)
    want = JaxLegacyServeLoop(jcfg, jbundle, jparams, batch_slots=slots,
                              s_max=s_max).run(
        [JaxRequest(rid=i, prompt=p, max_new=max_new)
         for i, p in enumerate(prompts)])
    cfg, bundle, params = _port(arch, mode)
    loop = LegacyServeLoop(cfg, bundle, params, batch_slots=slots,
                           s_max=s_max)
    got = loop.run([Request(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts)])
    return want, got, loop


@pytest.mark.parametrize("plen", [1, 5, 9, 48])
@pytest.mark.parametrize("jax_mode,mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_slot_matches_jax_and_the_decoupled_loop(arch, jax_mode, mode,
                                                     plen):
    cfg, bundle, params = _port(arch, mode)
    prompt = np.random.default_rng(plen).integers(0, cfg.vocab, size=plen)
    want, got, loop = _both(arch, jax_mode, mode, [prompt], 1, 64, 8)
    assert got == want
    assert len(got[0]) == 8
    # one token per full-batch step: the prompt, then max_new - 1 decodes
    assert loop.steps == plen + 7
    new = ServeLoop(cfg, bundle, params, batch_slots=1, s_max=64, chunk=16)
    assert new.run([Request(rid=0, prompt=prompt, max_new=8)]) == got


@pytest.mark.parametrize("jax_mode,mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_four_slots_matches_jax(arch, jax_mode, mode):
    """Six requests over four slots: every admission steps the other
    slots' caches once per prompt token, past s_max."""
    cfg = _port(arch, mode)[0]
    prompts = _mixed_prompts(6, cfg.vocab)
    want, got, loop = _both(arch, jax_mode, mode, prompts, 4, MIXED_S_MAX,
                            MAX_NEW)
    assert got == want
    assert sorted(got) == list(range(6))
    assert all(len(v) == MAX_NEW for v in got.values())
    lens = loop.cache[0]["attn"]["len"]
    assert int(lens.max()) > MIXED_S_MAX          # the polluted caches
    # every prompt token is a step of its own, then at least the 15
    # decode rounds of the last request admitted
    assert loop.steps >= sum(map(len, prompts)) + MAX_NEW - 1
    cfg, bundle, params = _port(arch, mode)
    new = ServeLoop(cfg, bundle, params, batch_slots=4, s_max=MIXED_S_MAX,
                    chunk=16).run([Request(rid=i, prompt=p, max_new=MAX_NEW)
                                   for i, p in enumerate(prompts)])
    assert new != got                 # the coupled loop's stalls show


@pytest.mark.parametrize("mode", ["kernel", "ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_past_an_unaligned_s_max_matches_the_reference_ref_mode(arch, mode):
    cfg = _port(arch, mode)[0]
    prompts = _mixed_prompts(6, cfg.vocab)
    want, got, loop = _both(arch, "ref", mode, prompts, 4, BENCH_S_MAX,
                            MAX_NEW)
    assert got == want
    assert int(loop.cache[0]["attn"]["len"].max()) > BENCH_S_MAX
    padded, _, _ = _both(arch, "pallas", mode, prompts, 4, BENCH_S_MAX,
                         MAX_NEW)
    assert padded != want


@pytest.mark.parametrize("jax_mode,mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_empty_prompt_matches_jax(arch, jax_mode, mode):
    cfg, bundle, params = _port(arch, mode)
    empty = np.zeros((0,), np.int64)
    want, got, _ = _both(arch, jax_mode, mode, [empty], 1, 32, 4)
    assert got == want
    assert len(got[0]) == 4
    bos = LegacyServeLoop(cfg, bundle, params, batch_slots=1, s_max=32).run(
        [Request(rid=0, prompt=np.array([0], np.int64), max_new=4)])
    assert bos == got
    new = ServeLoop(cfg, bundle, params, batch_slots=1, s_max=32).run(
        [Request(rid=0, prompt=empty, max_new=4)])
    assert new == got


@pytest.mark.parametrize("jax_mode,mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_max_new_zero_matches_jax(arch, jax_mode, mode):
    jcfg, jbundle, jparams = _jax(arch, jax_mode)
    cfg, bundle, params = _port(arch, mode)
    spec = [(np.array([3, 1], np.int64), 0), (np.array([2, 5], np.int64), 3),
            (np.array([7], np.int64), -1)]
    want = JaxLegacyServeLoop(jcfg, jbundle, jparams, batch_slots=1,
                              s_max=32).run(
        [JaxRequest(rid=i, prompt=p, max_new=n)
         for i, (p, n) in enumerate(spec)])
    loop = LegacyServeLoop(cfg, bundle, params, batch_slots=1, s_max=32)
    got = loop.run([Request(rid=i, prompt=p, max_new=n)
                    for i, (p, n) in enumerate(spec)])
    assert got == want
    assert got[0] == [] and got[2] == [] and len(got[1]) == 3
    assert loop.steps == 2 + 2


def test_eos_on_the_first_token_frees_the_slot():
    cfg, bundle, params = _port("qwen3-4b", "ref")
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, size=4)
    first = LegacyServeLoop(cfg, bundle, params, batch_slots=1,
                            s_max=32).run(
        [Request(rid=0, prompt=prompt, max_new=4)])[0][0]
    loop = LegacyServeLoop(cfg, bundle, params, batch_slots=1, s_max=32,
                           eos_id=first)
    res = loop.run([Request(rid=0, prompt=prompt, max_new=4),
                    Request(rid=1, prompt=prompt[:2], max_new=2)])
    assert res[0] == [first]
    assert loop.active == [None] and len(res[1]) >= 1


def test_validation_and_max_rounds():
    cfg, bundle, params = _port("qwen3-4b", "ref")
    loop = LegacyServeLoop(cfg, bundle, params, batch_slots=1, s_max=16)
    with pytest.raises(ValueError, match="duplicate"):
        loop.run([Request(rid=5, prompt=np.arange(3), max_new=2),
                  Request(rid=5, prompt=np.arange(4), max_new=2)])
    with pytest.raises(ValueError, match="s_max"):
        loop.run([Request(rid=0, prompt=np.arange(12), max_new=8)])
    loop = LegacyServeLoop(cfg, bundle, params, batch_slots=1, s_max=16)
    with pytest.raises(RuntimeError, match="max_rounds"):
        loop.run([Request(rid=0, prompt=np.arange(3), max_new=6)],
                 max_rounds=2)
    assert loop.device == torch.device("cpu")
