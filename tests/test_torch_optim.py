"""Parity of the port's optimizer with the JAX package's, on the CPU.

``warmup_cosine`` at steps 0-400 equal to JAX's within 1e-6 of the peak
(float32 cosines of two libraries, a few ulps apart); ``AdamW.update``
over three steps on identical numpy parameters and gradients, with
clipping on (the gradients' norm far above 1) and off, a constant and a
scheduled learning rate: parameters, moments and the global norm within
1e-6 relative, or 1e-6 of the leaf's largest value where a parameter
nears zero (float32, the update's terms rounded in other orders), the
step exact.  Then the port's own checks, as ``tests/test_substrates.py`` makes
them of JAX's: AdamW minimises a quadratic, and clipping bounds the
update.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JaxAdamW
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro_torch.models.convert import NamedParams
from repro_torch.optim import AdamW, OptState, warmup_cosine

RTOL = 1e-6
SHAPES = {"embed": (64, 16), "final_norm": (16,), "segments.0.0.attn.wq":
          (16, 32), "segments.0.1.attn.wq": (16, 32)}


@pytest.mark.parametrize("peak,warmup,total,floor",
                         [(3e-4, 200, 400, 0.1), (1e-3, 0, 100, 0.0),
                          (5e-2, 10, 10, 0.5)])
def test_warmup_cosine_matches_jax(peak, warmup, total, floor):
    steps = np.arange(401, dtype=np.int32)
    want = np.asarray(jax_warmup_cosine(peak, warmup, total, floor)(
        jnp.asarray(steps)))
    lr = warmup_cosine(peak, warmup, total, floor)
    got = lr(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * peak)
    assert float(lr(7)) == float(got[7])


def _arrays(seed, scale):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("scheduled", [False, True])
def test_adamw_update_matches_jax(clip, scheduled):
    lr = warmup_cosine(1e-2, 2, 10) if scheduled else 1e-2
    jlr = jax_warmup_cosine(1e-2, 2, 10) if scheduled else 1e-2
    opt = AdamW(lr=lr, clip_norm=clip)
    jopt = JaxAdamW(lr=jlr, clip_norm=clip)
    init = _arrays(0, 0.1)
    params = NamedParams((k, torch.from_numpy(v.copy()))
                         for k, v in init.items())
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state, jstate = opt.init(params), jopt.init(jparams)
    for step in range(3):
        grads = _arrays(10 + step, 5.0)       # global norm ~ 5 * 45
        params, state, gnorm = opt.update(
            NamedParams((k, torch.from_numpy(v)) for k, v in grads.items()),
            state, params)
        jparams, jstate, jgnorm = jopt.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        np.testing.assert_allclose(float(gnorm), float(jgnorm), rtol=RTOL)
        assert int(state.step) == int(jstate.step) == step + 1
        for k in SHAPES:
            for got, want in ((params[k], jparams[k]),
                              (state.m[k], jstate.m[k]),
                              (state.v[k], jstate.v[k])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=RTOL,
                    atol=RTOL * float(np.abs(want).max()), err_msg=k)


def test_adamw_state_layout():
    params = torch.nn.Linear(4, 3, bias=False)
    state = AdamW().init(params)
    assert isinstance(state, OptState)
    assert state.step.dtype == torch.int32 and state.step.device.type == "cpu"
    assert set(state.m) == set(state.v) == {"weight"}
    assert state.m["weight"].dtype == torch.float32
    assert state.m["weight"] is not state.v["weight"]


def test_adamw_minimizes_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = NamedParams(w=torch.tensor([3.0, -2.0]))
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clip_bounds_the_update():
    opt = AdamW(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    params = NamedParams(w=torch.zeros(4))
    state = opt.init(params)
    params, state, gnorm = opt.update({"w": torch.full((4,), 100.0)},
                                      state, params)
    assert float(gnorm) == pytest.approx(200.0)
    # Adam's first step is lr * sign(g) whatever the clip: |update| <= lr
    assert float(params["w"].abs().max()) <= 1.0 + 1e-6
