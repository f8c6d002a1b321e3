"""The sharded steps (``repro_torch.launch.steps.shard_train_step``,
``shard_prefill_step``, ``shard_serve_step``) against the JAX package's
unsharded steps, on the CPU.

- ``launch/specs.py`` against JAX's ``launch/specs.py`` for the five
  configurations the sharded steps cover (full size, no spawn): names,
  shapes and dtypes of the parameter tree, the train batch and the
  serve step's cache and arguments.
- The deferred configurations (MLA, the recurrent families, the
  encoder-decoder) and ``act_sp`` raise ``NotImplementedError``.
- A world of one rank in this process (gloo): on a (1, 1) mesh the three
  steps are bit-equal to ``make_train_step``/``make_prefill_step``/
  ``make_serve_step``.
- One 8-rank gloo spawn for the file (``tests/torch_rank_cases.py``;
  the ranks load no JAX), on JAX's ``tests/test_distributed.py`` mesh
  (2, 4) and on (1, 8), where every head is cut, for the smoke models of
  qwen3-4b, qwen2-72b (nonzero biases), granite-34b and
  granite-moe-3b-a800m: two train steps (``kernel_mode="ref"``, JAX's
  default optimizer) from JAX's numpy weights, the loss and grad norm
  within 1e-5 relative of JAX's ``make_train_step`` and the gathered
  moments m and parameters within 1e-4 of each leaf's largest value;
  the prefill logits and two greedy serve steps (each rank's logits
  shard and the gathered cache) within 1e-5 of JAX's ``ref``-mode
  ``make_prefill_step``/``make_serve_step`` (the port runs kernel mode,
  here its plain versions), the greedy tokens equal.  A vocab of 509,
  which ``model`` does not divide (the whole-vocab path), and a batch of
  3 on (2, 4), where the cache is cut on its sequence.  An MoE whose
  experts overflow (capacity factor 0.5) against the port's own
  unsharded steps (JAX loses a kept token there, ROADMAP §C4).  Each
  rank holds only its shard of every leaf, in storage of its own.  A
  backward outside the step's context (as the card's autograd thread
  runs it) recomputes the remat'd layers on the same shards.

``bk``'s gradient is zero up to rounding (a key bias shifts every
logit of a query by the same amount), so its moment m is held to the
largest m of the model, not to its own.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_rank_cases as rc
from repro.configs import get_config as jax_get_config
from repro.configs.shapes import InputShape as JaxInputShape
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import specs, steps
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel.sharding import param_shardings, place

WORLD = 8
B, S, S_MAX = 8, 32, 16
ARCHS = ("qwen3-4b", "qwen2-72b", "granite-34b", "granite-moe-3b-a800m")
SPEC_ARCHS = ARCHS + ("chameleon-34b",)
DEFERRED = ("minicpm3-4b", "deepseek-v2-lite-16b", "rwkv6-1.6b",
            "hymba-1.5b", "seamless-m4t-large-v2")
MESHES = ((2, 4), (1, 8))
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4          # of each leaf's largest |value|
LOGIT_ATOL = 1e-5
# weights: (arch, config overrides)
WEIGHTS = {**{a: (a, {}) for a in ARCHS},
           "qwen3-4b-v509": ("qwen3-4b", {"vocab": 509})}
# backward outside the step's context: two cases (FSDP with TP, and
# experts cut over model)
OUTSIDE = ("qwen3-4b@2x4", "granite-moe-3b-a800m@2x4")
CASES = {
    **{f"{a}@{d}x{m}": dict(arch=a, weights=a, mesh=(d, m), train=2,
                            prefill=True, serve=(B,), s_max=S_MAX,
                            outside=f"{a}@{d}x{m}" in OUTSIDE)
       for a in ARCHS for d, m in MESHES},
    "vocab509@2x4": dict(arch="qwen3-4b", weights="qwen3-4b-v509",
                         overrides={"vocab": 509}, mesh=(2, 4), train=2,
                         prefill=True, serve=(B,), s_max=S_MAX),
    "batch3@2x4": dict(arch="qwen3-4b", weights="qwen3-4b", mesh=(2, 4),
                       serve=(3,), s_max=S_MAX),
    "moe_batch3@2x4": dict(arch="granite-moe-3b-a800m",
                           weights="granite-moe-3b-a800m", mesh=(2, 4),
                           serve=(3,), s_max=S_MAX),
    "overflow@2x4": dict(arch="granite-moe-3b-a800m",
                         weights="granite-moe-3b-a800m", mesh=(2, 4),
                         overrides={"capacity_factor": 0.5}, train=2,
                         own_ref=True, prefill=True, prefill_mode="ref"),
}
JAX_CASES = sorted(k for k in CASES if k != "overflow@2x4")
_MEMO = {}


def _memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _weights(key):
    """JAX's smoke weights (qwen2-72b's biases drawn nonzero) and their
    numpy tree."""
    def make():
        arch, ov = WEIGHTS[key]
        cfg = jax_get_config(arch, smoke=True, **ov)
        tree = jax.tree.map(np.asarray, jax.jit(jax_build_model(cfg).init)(
            jax.random.PRNGKey(0)))
        rng = np.random.default_rng(1)
        for seg in tree["segments"]:
            for name in ("bq", "bk", "bv"):
                if name in seg["attn"]:
                    seg["attn"][name] = rng.normal(
                        0, 0.5, seg["attn"][name].shape).astype(np.float32)
        return tree
    return _memo(("w", key), make)


def _inputs(key):
    arch, ov = WEIGHTS[key]
    vocab = get_config(arch, smoke=True, **ov).vocab
    rng = np.random.default_rng(7)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _jcfg(key, **extra):
    arch, ov = WEIGHTS[key]
    return jax_get_config(arch, smoke=True, kernel_mode="ref", **ov, **extra)


def _jax_train(key):
    def make():
        cfg = _jcfg(key)
        step = jax.jit(jsteps.make_train_step(cfg))
        params = jax.tree.map(jnp.asarray, _weights(key))
        state = jsteps.default_optimizer().init(params)
        batch = {k: jnp.asarray(v) for k, v in _inputs(key).items()}
        metrics = []
        for _ in range(2):
            params, state, m = step(params, state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return (metrics, jax.tree.map(np.asarray, params),
                jax.tree.map(np.asarray, state.m))
    return _memo(("train", key), make)


def _jax_prefill(key):
    def make():
        step = jax.jit(jsteps.make_prefill_step(_jcfg(key)))
        return np.asarray(step(jax.tree.map(jnp.asarray, _weights(key)),
                               {"tokens": jnp.asarray(
                                   _inputs(key)["tokens"])}))
    return _memo(("prefill", key), make)


def _jax_serve(key, batch):
    def make():
        cfg = _jcfg(key)
        step = jax.jit(jsteps.make_serve_step(cfg))
        params = jax.tree.map(jnp.asarray, _weights(key))
        cache = jax_build_model(cfg).cache_init(batch, S_MAX)
        tok = jnp.asarray(_inputs(key)["tokens"][:batch, 0])
        pos = jnp.zeros((batch,), jnp.int32)
        logits, tokens = [], []
        for _ in range(2):
            lg, cache = step(params, cache, tok, pos)
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            tokens.append(np.asarray(tok).tolist())
            pos = pos + 1
        return logits, tokens, jax.tree.map(np.asarray, cache)
    return _memo(("serve", key, batch), make)


def _warm_jax():
    for name in JAX_CASES:
        case = CASES[name]
        if case.get("train"):
            _jax_train(case["weights"])
        if case.get("prefill"):
            _jax_prefill(case["weights"])
        for batch in case.get("serve", ()):
            _jax_serve(case["weights"], batch)


@pytest.fixture(scope="module")
def ranks():
    """Every case on 8 gloo ranks, in one spawn; JAX's references are
    computed in this process meanwhile."""
    weights = {k: _weights(k) for k in WEIGHTS}
    inputs = {k: _inputs(k) for k in WEIGHTS}
    box = {}

    def run():
        try:
            box["out"] = spawn(rc.shard_step_cases, WORLD, weights, CASES,
                               inputs, timeout=600)
        except BaseException as e:        # re-raised below
            box["err"] = e
    th = threading.Thread(target=run)
    th.start()
    _warm_jax()
    th.join()
    if "err" in box:
        raise box["err"]
    return [r["cases"] for r in box["out"]], box["out"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _jflat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "".join(f"/{getattr(p, 'key', getattr(p, 'idx', p))}"
                      for p in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _pflat(tree):
    return {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in _flat(tree).items()}


# -- specs, the deferred configurations, a world of one -----------------------


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_specs_equal_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    train, decode = JaxInputShape("t", 4096, 256, "train"), \
        JaxInputShape("d", 32768, 128, "decode")
    got = specs.param_specs(cfg)
    assert all(t.device.type == "meta" for t in _flat(got).values())
    assert _pflat(got) == _jflat(jspecs.param_specs(jcfg))
    assert _pflat(specs.train_batch_specs(cfg, train)) == \
        _jflat(jspecs.train_batch_specs(jcfg, train))
    cache, args = specs.decode_arg_specs(cfg, decode)
    jcache, jargs = jspecs.decode_arg_specs(jcfg, decode)
    assert _pflat(cache) == _jflat(jcache)
    assert _pflat(args) == _jflat(jargs)


@pytest.mark.parametrize("arch", DEFERRED + ("act_sp",))
@pytest.mark.parametrize("which", ("train", "prefill", "serve"))
def test_deferred_configurations_raise(arch, which):
    cfg = (get_config("qwen3-4b", smoke=True, act_sp=True)
           if arch == "act_sp" else get_config(arch, smoke=True))
    mesh = make_debug_mesh((1, 1), ("data", "model"),
                           devices=[torch.device("cpu")])
    fn = {"train": steps.shard_train_step,
          "prefill": steps.shard_prefill_step,
          "serve": steps.shard_serve_step}[which]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fn(cfg, mesh, InputShape("x", 16, 2, which), device="cpu")


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_debug_mesh((1, 1), ("data", "model"), ranks=True)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ("qwen3-4b", "granite-moe-3b-a800m"))
def test_one_rank_steps_are_bit_equal(world_of_one, arch):
    """The sharded steps on a (1, 1) mesh compute what the unsharded
    steps compute, bit for bit (``chip_smoke.py`` phase 15 at full
    width on the card)."""
    mesh, tree, inp = world_of_one, _weights(arch), _inputs(arch)
    tokens = torch.from_numpy(inp["tokens"])
    cfg = get_config(arch, smoke=True)
    a = params_from_numpy(cfg, tree, device="cpu")
    # place keeps a replicated leaf's tensor: b gets storage of its own
    b = place(params_from_numpy(cfg, tree, device="cpu"), mesh,
              param_shardings(a, mesh))
    want = steps.make_prefill_step(cfg, device="cpu")(a, {"tokens": tokens})
    step, _ = steps.shard_prefill_step(cfg, mesh, InputShape("p", S, B, "p"))
    assert torch.equal(step(b, {"tokens": tokens}), want)
    ca = steps.build_model(cfg, device="cpu").cache_init(B, S_MAX)
    cb = steps.build_model(cfg, device="cpu").cache_init(B, S_MAX)
    ref = steps.make_serve_step(cfg, device="cpu")
    step, _ = steps.shard_serve_step(cfg, mesh,
                                     InputShape("d", S_MAX, B, "decode"))
    tok, pos = tokens[:, 0], torch.zeros(B, dtype=torch.int32)
    for _ in range(2):
        la, ca = ref(a, ca, tok, pos)
        lb, cb = step(b, cb, tok, pos)
        assert torch.equal(la, lb)
        tok, pos = la.argmax(-1).to(torch.int32), pos + 1
    for x, y in zip(_flat(ca).values(), _flat(cb).values()):
        assert torch.equal(x, y)
    cfg = get_config(arch, smoke=True, kernel_mode="ref")
    a = params_from_numpy(cfg, tree, device="cpu", dtype=cfg.pdtype)
    b = place(params_from_numpy(cfg, tree, device="cpu", dtype=cfg.pdtype),
              mesh, param_shardings(a, mesh))
    opt = steps.default_optimizer()
    sa, sb = opt.init(a), opt.init(b)
    ref = steps.make_train_step(cfg, opt, device="cpu")
    step, _ = steps.shard_train_step(cfg, mesh, InputShape("t", S, B, "t"),
                                     optimizer=opt)
    batch = {k: torch.from_numpy(v) for k, v in inp.items()}
    for _ in range(2):
        a, sa, ma = ref(a, sa, batch)
        b, sb, mb = step(b, sb, batch)
        assert float(ma["loss"]) == float(mb["loss"])
        assert float(ma["grad_norm"]) == float(mb["grad_norm"])
    for (n, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), n


def test_init_shards_draws_what_one_card_draws(world_of_one):
    cfg = get_config("qwen2-72b", smoke=True)
    want = steps.build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    got = steps.init_shards(cfg, torch.Generator().manual_seed(3),
                            world_of_one)
    for (n, x), (m, y) in zip(want.named_parameters(),
                              got.named_parameters()):
        assert n == m and x.dtype == y.dtype and torch.equal(x, y), n


# -- eight ranks ------------------------------------------------------------------


def test_spawned_ranks_load_no_jax(ranks):
    _, raw = ranks
    assert len(raw) == WORLD and not any(r["jax_loaded"] for r in raw)


def _close_leaves(got, want, name, m_scale=None):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), name
    for k, wv in w.items():
        wv = np.asarray(wv)
        scale = float(np.abs(wv).max())
        if m_scale is not None and k.endswith("/bk"):
            scale = m_scale
        err = float(np.abs(g[k] - wv).max())
        assert err <= LEAF_TOL * scale, (name, k, err, scale)


@pytest.mark.parametrize("name", [n for n in JAX_CASES
                                  if CASES[n].get("train")])
def test_train_steps_match_jax(ranks, name):
    out, _ = ranks
    case = CASES[name]
    metrics, params, m = _jax_train(case["weights"])
    for r in range(WORLD):
        got = out[r][name]["train"]
        assert got["step"] == 2
        for (loss, gn), (jl, jg) in zip(got["metrics"], metrics):
            assert abs(loss - jl) <= LOSS_RTOL * abs(jl), (r, loss, jl)
            assert abs(gn - jg) <= LOSS_RTOL * abs(jg), (r, gn, jg)
    got = out[0][name]["train"]
    _close_leaves(got["params"], params, name)
    m_scale = max(float(np.abs(np.asarray(v)).max())
                  for v in _flat(m).values())
    _close_leaves(got["m"], m, name, m_scale)


@pytest.mark.parametrize("name", OUTSIDE)
def test_recomputed_layers_keep_the_step_shards(ranks, name):
    """A backward run outside the step's context (as the card's autograd
    thread runs it) recomputes each layer on the same shards: the
    gradients equal a backward inside it."""
    out, _ = ranks
    for r in range(WORLD):
        inside, outside = out[r][name]["train"]["backward_outside"]
        assert outside == inside, r


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n].get("train")])
def test_each_rank_holds_only_its_shards(ranks, name):
    out, _ = ranks
    for r in range(WORLD):
        assert out[r][name]["train"]["bad_shards"] == [], r


def _mesh_of(name, r):
    d, m = CASES[name]["mesh"]
    return divmod(r, m), d, m


@pytest.mark.parametrize("name", [n for n in JAX_CASES
                                  if CASES[n].get("prefill")])
def test_prefill_step_matches_jax(ranks, name):
    out, _ = ranks
    want = _jax_prefill(CASES[name]["weights"])
    for r in range(WORLD):
        (i, _), d, _ = _mesh_of(name, r)
        n = B // d
        got = out[r][name]["prefill"]
        assert got.shape == (n, want.shape[1])
        np.testing.assert_allclose(got, want[i * n:(i + 1) * n], rtol=0,
                                   atol=LOGIT_ATOL)


@pytest.mark.parametrize("name", [n for n in JAX_CASES
                                  if CASES[n].get("serve")])
def test_serve_steps_match_jax(ranks, name):
    """Each rank's logits shard is JAX's out sharding (``P(dp if B
    divides, "model" if V divides)``) of JAX's logits; the greedy
    tokens and the gathered cache equal JAX's."""
    out, _ = ranks
    case = CASES[name]
    batch = case["serve"][0]
    logits, tokens, cache = _jax_serve(case["weights"], batch)
    vocab = logits[0].shape[1]
    for r in range(WORLD):
        (i, j), d, m = _mesh_of(name, r)
        got = out[r][name][f"serve_{batch}"]
        rows = slice(i * batch // d, (i + 1) * batch // d) \
            if batch % d == 0 else slice(0, batch)
        cols = slice(j * vocab // m, (j + 1) * vocab // m) \
            if vocab % m == 0 else slice(0, vocab)
        assert got["tokens"] == tokens, r
        for g, w in zip(got["logits"], logits):
            assert g.shape == w[rows, cols].shape, r
            np.testing.assert_allclose(g, w[rows, cols], rtol=0,
                                       atol=LOGIT_ATOL)
        k_local = got["cache_k_local"]
        if batch % d:             # the cache is cut on its sequence
            assert k_local[1] == batch and k_local[3] == S_MAX // d
        else:
            assert k_local[1] == batch // d and k_local[3] == S_MAX
    got = out[0][name][f"serve_{batch}"]["cache"]
    for seg, jseg in zip(got, cache):
        for k in ("k", "v", "len"):
            np.testing.assert_allclose(seg[k], jseg["attn"][k], rtol=0,
                                       atol=LOGIT_ATOL)


def test_whole_vocab_where_model_does_not_divide_it(ranks):
    out, _ = ranks
    assert out[0]["vocab509@2x4"]["serve_8"]["logits"][0].shape == (4, 509)
    assert out[0]["qwen3-4b@2x4"]["serve_8"]["logits"][0].shape == (4, 128)


def test_overflowing_experts_match_the_unsharded_steps(ranks):
    """Capacity 0.5: the sharded step drops the pairs the unsharded step
    drops (the capacity and each pair's queue place count every rank's
    tokens)."""
    out, _ = ranks
    got = out[0]["overflow@2x4"]["train"]
    for (loss, gn), (rl, rg) in zip(got["metrics"], got["ref_metrics"]):
        assert abs(loss - rl) <= LOSS_RTOL * abs(rl)
        assert abs(gn - rg) <= LOSS_RTOL * abs(rg)
    _close_leaves(got["params"], got["ref_params"], "overflow")
    _close_leaves(got["m"], got["ref_m"], "overflow")
    # the drops are real: dropless, the loss differs
    key = "granite-moe-3b-a800m"
    dropless = _jax_train(key)[0][0][0]
    assert abs(got["ref_metrics"][0][0] - dropless) > 1e-4
    cfg = get_config(key, smoke=True, kernel_mode="ref",
                     capacity_factor=0.5)
    want = steps.make_prefill_step(cfg, device="cpu")(
        params_from_numpy(cfg, _weights(key), device="cpu"),
        {"tokens": torch.from_numpy(_inputs(key)["tokens"])})
    for r in range(WORLD):
        (i, _), d, _ = _mesh_of("overflow@2x4", r)
        n = B // d
        np.testing.assert_allclose(out[r]["overflow@2x4"]["prefill"],
                                   want[i * n:(i + 1) * n].numpy(), rtol=0,
                                   atol=LOGIT_ATOL)
