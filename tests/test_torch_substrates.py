"""The port's data pipeline, checkpoints, training loop and straggler
monitor against the JAX package's (the counterpart of
``tests/test_substrates.py``), on the CPU.

``SyntheticLM`` batches bit-identical to JAX's; checkpoints cross both
ways (JAX writes {params, opt} and the port restores equal tensors; the
port writes, bfloat16 leaves included, and JAX's ``load_pytree`` restores
equal arrays) under the same keys; the manager's retention, atomic
publish and an async save that holds the values of the moment it was
asked for, though the parameters change in place right after; ``fit``
lowers the loss, recovers from an injected failure, resumes across a
fresh call, and its first five losses on qwen3-4b's smoke model are
within 1e-4 relative of JAX's ``fit`` (float32 through two layers and
five AdamW steps).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.checkpoint import save_pytree as jax_save_pytree
from repro.configs import get_config as jax_get_config
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.registry import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.runtime import TrainLoopConfig as JaxTrainLoopConfig
from repro.runtime import fit as jax_fit
from repro_torch.checkpoint import (CheckpointManager, load_pytree,
                                    save_pytree)
from repro_torch.checkpoint import io as cio
from repro_torch.configs import get_config
from repro_torch.data import PrefetchLoader, SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.transformer import LM
from repro_torch.optim import AdamW
from repro_torch.runtime import StragglerMonitor, TrainLoopConfig, fit
from repro_torch.runtime.train_loop import StepFailure

ARCH = "qwen3-4b"
FIT_RTOL = 1e-4
_CACHE = {}


def _jax():
    if "jax" not in _CACHE:
        cfg = jax_get_config(ARCH, smoke=True)
        params = jax.jit(jax_build_model(cfg).init)(jax.random.PRNGKey(0))
        _CACHE["jax"] = (cfg, params, jax.tree.map(np.asarray, params))
    return _CACHE["jax"]


def _port_params(dtype=torch.float32, **overrides):
    cfg = get_config(ARCH, smoke=True, kernel_mode="ref", **overrides)
    return cfg, params_from_numpy(cfg, _jax()[2], device="cpu", dtype=dtype)


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("frames_dim", [0, 8])
def test_synthetic_batches_equal_jax(frames_dim):
    ds = SyntheticLM(vocab=100, seq_len=16, global_batch=4, seed=7,
                     frames_dim=frames_dim)
    jds = JaxSyntheticLM(vocab=100, seq_len=16, global_batch=4, seed=7,
                         frames_dim=frames_dim)
    for step in (0, 1, 12):
        a, b = ds.batch_at(step), jds.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    a = ds.batch_at(12)
    assert a["labels"][0, -1] == -1
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    it = ds.iter_from(3)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  ds.batch_at(3)["tokens"])


def test_prefetch_loader_order_and_close():
    loader = PrefetchLoader(iter(range(20)), capacity=3)
    assert list(loader) == list(range(20))
    ds = SyntheticLM(vocab=50, seq_len=8, global_batch=2)
    loader = PrefetchLoader(ds.iter_from(0), capacity=2,
                            transform=lambda b: b["tokens"].sum())
    got = [next(loader) for _ in range(5)]
    assert got == [ds.batch_at(i)["tokens"].sum() for i in range(5)]
    loader.close()
    loader._thread.join(timeout=5.0)
    assert not loader._thread.is_alive()


# -- checkpoints across packages ----------------------------------------------


def _jax_state():
    """JAX's params and AdamW state after one update (m, v nonzero)."""
    cfg, params, _ = _jax()
    opt = JaxAdamW(lr=1e-3)
    state = opt.init(params)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.01, params)
    params, state, _ = opt.update(grads, state, params)
    return params, state


def test_port_loads_jax_checkpoint(tmp_path):
    jparams, jopt = _jax_state()
    jax_save_pytree(tmp_path / "ck.npz", {"params": jparams, "opt": jopt},
                    meta={"step": 1})
    cfg, params = _port_params()
    with torch.no_grad():
        for p in params.parameters():
            p.zero_()
    opt = AdamW().init(params)
    state, meta = load_pytree(tmp_path / "ck.npz",
                              {"params": params, "opt": opt})
    assert meta == {"step": 1}
    assert state["params"] is params
    assert int(state["opt"].step) == 1
    for got, want in ((params_to_numpy(params), jparams),
                      (params_to_numpy(state["opt"].m), jopt.m),
                      (params_to_numpy(state["opt"].v), jopt.v)):
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_flatten_with_path(want)[0]):
            np.testing.assert_array_equal(g, np.asarray(w),
                                          err_msg=str(path))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jax_loads_port_checkpoint(tmp_path, dtype):
    cfg, params = _port_params(dtype=dtype)
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    grads = {k: torch.full_like(p, 0.01, dtype=torch.float32)
             for k, p in params.named_parameters()}
    params, state, _ = opt.update(grads, state, params)
    save_pytree(tmp_path / "ck.npz", {"params": params, "opt": state},
                meta={"step": 1})
    jparams, jopt = _jax_state()
    jax_save_pytree(tmp_path / "jax.npz", {"params": jparams, "opt": jopt})
    with np.load(tmp_path / "ck.npz") as z, np.load(tmp_path / "jax.npz") as j:
        assert sorted(z.files) == sorted(j.files)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    like_params = jax.tree.map(jnp.asarray, params_to_numpy(params))
    like_params = {**like_params, "segments": [
        jax.tree.map(lambda a: a.astype(jdt) if a.ndim >= 3 else a, seg)
        for seg in like_params["segments"]]}
    if "unembed" in like_params:
        like_params["unembed"] = like_params["unembed"].astype(jdt)
    like = {"params": like_params, "opt": JaxAdamW().init(jparams)}
    restored, meta = jax_load_pytree(tmp_path / "ck.npz", like)
    assert meta == {"step": 1}
    assert int(restored["opt"].step) == 1
    for got, want in ((restored["params"], params_to_numpy(params)),
                      (restored["opt"].m, params_to_numpy(state.m)),
                      (restored["opt"].v, params_to_numpy(state.v))):
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_flatten_with_path(want)[0]):
            np.testing.assert_array_equal(np.asarray(g).astype(np.float32),
                                          w, err_msg=str(path))
    wq = restored["params"]["segments"][0]["attn"]["wq"]
    assert wq.dtype == jdt
    # and back: the port restores its own bfloat16 leaves bit for bit
    _, again = _port_params(dtype=dtype)
    load_pytree(tmp_path / "ck.npz", {"params": again,
                                      "opt": AdamW().init(again)})
    for (k, a), (_, b) in zip(params.named_parameters(),
                              again.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_load_rejects_missing_and_misshapen_leaves(tmp_path):
    save_pytree(tmp_path / "a.npz", {"x": torch.zeros(3), "y": np.ones(2)})
    with pytest.raises(KeyError, match="z"):
        load_pytree(tmp_path / "a.npz", {"z": torch.zeros(3)})
    with pytest.raises(ValueError, match="x"):
        load_pytree(tmp_path / "a.npz", {"x": torch.zeros(4)})
    tree, _ = load_pytree(tmp_path / "a.npz", {"x": torch.ones(3),
                                                "y": np.zeros(2)})
    assert torch.equal(tree["x"], torch.zeros(3))
    np.testing.assert_array_equal(tree["y"], np.ones(2))


# -- the manager --------------------------------------------------------------


def test_manager_retention_and_resume(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=True)
    x = torch.zeros(4)
    for step in (1, 2, 3, 4):
        x.fill_(step)
        mgr.save(step, {"x": x})
    mgr.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000003.npz", "step_00000004.npz"]
    assert [w.step for w in mgr.writes] == [1, 2, 3, 4]
    assert all(w.nbytes > 0 and w.seconds >= 0 for w in mgr.writes)
    mgr2 = CheckpointManager(tmp_path, keep=2, async_write=False)
    assert mgr2.latest_step() == 4
    step, state, meta = mgr2.restore_latest({"x": torch.zeros(4)})
    assert step == 4 and meta["step"] == 4
    assert torch.equal(state["x"], torch.full((4,), 4.0))


def test_atomic_publish_leaves_no_partial_file(tmp_path, monkeypatch):
    save_pytree(tmp_path / "step_00000001.npz", {"x": torch.ones(2)})

    def broken(f, **arrays):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(cio.np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        save_pytree(tmp_path / "step_00000002.npz", {"x": torch.ones(2)})
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000001.npz"]


def test_async_save_holds_the_state_it_was_given(tmp_path):
    """The parameters change in place right after ``save`` returns (a
    slow write keeps the file unwritten meanwhile); the file holds the
    values of the moment ``save`` was called."""
    cfg, params = _port_params()
    opt = AdamW().init(params)
    before = {k: p.detach().clone() for k, p in params.named_parameters()}
    mgr = CheckpointManager(tmp_path, async_write=True)
    write = mgr._write

    def slow(*args):
        time.sleep(0.3)
        write(*args)

    mgr._write = slow
    mgr.save(1, {"params": params, "opt": opt})
    with torch.no_grad():
        for p in params.parameters():
            p.add_(1.0)
    opt.m["embed"].fill_(5.0)
    mgr.close()
    _, fresh = _port_params()
    state = mgr.restore_latest({"params": fresh,
                                "opt": AdamW().init(fresh)})[1]
    for k, p in fresh.named_parameters():
        assert torch.equal(p, before[k]), k
    assert float(state["opt"].m["embed"].abs().max()) == 0.0


# -- the fault-tolerant loop --------------------------------------------------


def _setup(lr=3e-3):
    cfg, params = _port_params()
    opt = AdamW(lr=lr)
    step = make_train_step(cfg, opt, device="cpu")
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=4)
    return params, opt.init(params), step, ds


def test_fit_loss_decreases(tmp_path):
    params, opt_state, step, ds = _setup()
    cfg = TrainLoopConfig(total_steps=20, ckpt_every=10,
                          ckpt_dir=str(tmp_path), async_ckpt=False)
    out = fit(step, params, opt_state, ds.batch_at, cfg)
    assert out["steps"] == 20
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])


def test_fit_first_losses_match_jax(tmp_path):
    jcfg, jparams, _ = _jax()
    jopt = JaxAdamW(lr=3e-3)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt))
    jds = JaxSyntheticLM(vocab=jcfg.vocab, seq_len=16, global_batch=4)
    want = jax_fit(jstep, jparams, jopt.init(jparams), jds.batch_at,
                   JaxTrainLoopConfig(total_steps=5, ckpt_every=5,
                                      ckpt_dir=str(tmp_path / "jax"),
                                      async_ckpt=False))["losses"]
    params, opt_state, step, ds = _setup()
    got = fit(step, params, opt_state, ds.batch_at,
              TrainLoopConfig(total_steps=5, ckpt_every=5,
                              ckpt_dir=str(tmp_path / "port"),
                              async_ckpt=False))["losses"]
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL)


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_fit_recovers_from_failures(tmp_path, async_ckpt):
    params, opt_state, step, ds = _setup()
    cfg = TrainLoopConfig(total_steps=8, ckpt_every=3,
                          ckpt_dir=str(tmp_path), async_ckpt=async_ckpt)
    tripped = {"done": False}

    def failure_hook(s):
        if s == 5 and not tripped["done"]:
            tripped["done"] = True
            raise StepFailure("injected node failure at step 5")

    out = fit(step, params, opt_state, ds.batch_at, cfg,
              failure_hook=failure_hook)
    assert out["steps"] == 8
    assert out["restarts"] == 1
    # resumed from the step-3 checkpoint, so steps 3 and 4 were replayed
    assert len(out["losses"]) == 10
    assert out["losses"][3:5] == pytest.approx(out["losses"][5:7], rel=1e-6)


def test_fit_gives_up_after_max_restarts(tmp_path):
    params, opt_state, step, ds = _setup()
    cfg = TrainLoopConfig(total_steps=4, ckpt_every=2, max_restarts=1,
                          ckpt_dir=str(tmp_path), async_ckpt=False)

    def always(s):
        if s == 3:
            raise StepFailure("down for good")

    with pytest.raises(StepFailure):
        fit(step, params, opt_state, ds.batch_at, cfg, failure_hook=always)


def test_fit_resumes_across_calls(tmp_path):
    """A second call with a fresh initial state resumes from the first's
    last checkpoint: its two steps repeat those of one uninterrupted
    run's steps 4 and 5."""
    params, opt_state, step, ds = _setup()
    cfg = TrainLoopConfig(total_steps=4, ckpt_every=2,
                          ckpt_dir=str(tmp_path / "a"), async_ckpt=True)
    fit(step, params, opt_state, ds.batch_at, cfg)
    params, opt_state, step, ds = _setup()
    cfg2 = TrainLoopConfig(total_steps=6, ckpt_every=2,
                           ckpt_dir=str(tmp_path / "a"), async_ckpt=True)
    out = fit(step, params, opt_state, ds.batch_at, cfg2)
    assert out["steps"] == 6
    assert len(out["losses"]) == 2
    assert int(out["state"]["opt"].step) == 6
    params, opt_state, step, ds = _setup()
    whole = fit(step, params, opt_state, ds.batch_at,
                TrainLoopConfig(total_steps=6, ckpt_every=6,
                                ckpt_dir=str(tmp_path / "b"),
                                async_ckpt=False))
    assert out["losses"] == pytest.approx(whole["losses"][4:], rel=1e-6)


# -- straggler monitor --------------------------------------------------------


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=2.0, warmup_steps=3)
    for s in range(20):
        dur = 1.0 if s != 15 else 5.0
        mon.stop(s, duration=dur)
    assert len(mon.events) == 1
    assert mon.events[0].step == 15
    assert mon.events[0].ratio > 2.0
    # EWMA not polluted by the outlier
    assert abs(mon.ewma - 1.0) < 0.05
    mon.start()
    assert mon.stop(20) is False
    with pytest.raises(RuntimeError, match="start"):
        mon.stop(21)


def test_lm_state_layout_matches_jax_keys(tmp_path):
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    model = LM(cfg, torch.device("cpu"), torch.Generator().manual_seed(0),
               dtype=torch.float32)
    flat, dtypes = cio.flatten({"params": model})
    jparams = jax.jit(jax_build_model(jax_get_config(
        "granite-moe-3b-a800m", smoke=True)).init)(jax.random.PRNGKey(0))
    jflat = {"/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                      for e in path): np.shape(leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(
                 {"params": jparams})[0]}
    assert {k: v.shape for k, v in flat.items()} == jflat
    assert set(dtypes.values()) == {"float32"}
