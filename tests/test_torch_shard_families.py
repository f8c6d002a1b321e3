"""The sharded steps (``repro_torch.launch.steps.shard_train_step``,
``shard_prefill_step``, ``shard_serve_step``) for the MLA decoders
(minicpm3-4b, deepseek-v2-lite-16b), the recurrent families (rwkv6-1.6b,
hymba-1.5b) and the encoder-decoder (seamless-m4t-large-v2) against the
JAX package's unsharded steps, on the CPU.

- One 8-rank gloo spawn for the file (``tests/torch_rank_cases.py``;
  the ranks load no JAX), JAX's references computed once per
  configuration in this process meanwhile.  On meshes (2, 4) and
  (1, 8), where every smoke head is cut (half an MLA head, half an RWKV
  head, Hymba's ``w_in`` giving ranks x or z), for each smoke model: two
  train steps (``kernel_mode="ref"``, JAX's default optimizer) from
  JAX's numpy weights, the loss and grad norm within 1e-5 relative of
  JAX's ``make_train_step`` and the gathered moments m and parameters
  within 1e-4 of each leaf's largest value; the prefill step's logits
  (seamless: its rows of the encoder output) within 1e-5 of JAX's
  ``make_prefill_step``; two greedy serve steps (each rank's logits
  shard, and the gathered cache or recurrent state) within 1e-5 of
  JAX's ``make_serve_step``, the greedy tokens equal.
- JAX's Hymba serve case as ``tests/test_distributed.py`` writes it:
  ``InputShape("d", 64, 8, "decode")`` on (2, 4), ``cache_init(8,
  64)``, token 0 at positions 0 and 1.
- Hymba's own 25:5 head ratio at a narrow width (d_model 200, heads of
  8) on (1, 4), where rank 0 attends query heads 0-6 over KV heads 0-1
  (one attention call a KV group); the same arithmetic at full width.
- An MLA batch of 3 on (2, 4), where the latent cache is cut on its
  sequence.
- ``act_sp`` (the residual stream cut along its tokens over ``model``)
  on (2, 4) for the five, held to JAX's steps without it: the train
  steps, the prefill step (the encoder's output gathered whole) and the
  serve steps, which run as without it; Hymba's ``w_bcdt`` partial
  product stays an all-reduce.  deepseek-v2-lite-16b on a (2, 2, 2)
  ``("pod", "data", "model")`` mesh.
- A world of one rank in this process: on a (1, 1) mesh the three
  steps are bit-equal to the unsharded ones, and ``init_shards`` draws
  what ``bundle.init`` draws, for the five.
- A backward outside the step's context (as the card's autograd thread
  runs it) recomputes the encoder-decoder's remat'd layers on the same
  shards.
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
from repro.launch import steps as jsteps
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.models import attention
from repro_torch.parallel import sharding

WORLD = 8
B, S, S_MAX = 8, 32, 16
ARCHS = ("minicpm3-4b", "deepseek-v2-lite-16b", "rwkv6-1.6b", "hymba-1.5b",
         "seamless-m4t-large-v2")
MESHES = ((2, 4), (1, 8))
SP = {"act_sp": True}
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4          # of each leaf's largest |value|
LOGIT_ATOL = 1e-5
RWKV, RWKV_ATOL = "rwkv6-1.6b", 1e-4
STRADDLE = {"d_model": 200, "n_heads": 25, "n_kv_heads": 5, "head_dim": 8}
# weights: (arch, config overrides); JAX's Hymba serve case keeps JAX's
# init as it is, the other Hymba weights draw conv_b nonzero
WEIGHTS = {**{a: (a, {}) for a in ARCHS},
           "hymba-straddle": ("hymba-1.5b", STRADDLE),
           "hymba-jax": ("hymba-1.5b", {})}
CASES = {
    **{f"{a}@{d}x{m}": dict(arch=a, weights=a, mesh=(d, m), train=2,
                            prefill=True, serve=(B,), s_max=S_MAX,
                            outside=(a, d) == ("seamless-m4t-large-v2", 2))
       for a in ARCHS for d, m in MESHES},
    "hymba-jax-serve@2x4": dict(arch="hymba-1.5b", weights="hymba-jax",
                                mesh=(2, 4), serve=(8,), s_max=64,
                                feed_zeros=True),
    "hymba-straddle@1x4": dict(arch="hymba-1.5b", weights="hymba-straddle",
                               overrides=STRADDLE, mesh=(1, 4), train=2,
                               prefill=True, serve=(B,), s_max=S_MAX,
                               heads=True),
    "minicpm3-batch3@2x4": dict(arch="minicpm3-4b", weights="minicpm3-4b",
                                mesh=(2, 4), serve=(3,), s_max=S_MAX),
    "deepseek-batch3@2x4": dict(arch="deepseek-v2-lite-16b",
                                weights="deepseek-v2-lite-16b", mesh=(2, 4),
                                serve=(3,), s_max=S_MAX),
    # act_sp, held to JAX's steps without it
    **{f"{a}+sp@2x4": dict(arch=a, weights=a, mesh=(2, 4), overrides=SP,
                           train=2, prefill=True, serve=(B,), s_max=S_MAX)
       for a in ARCHS},
    "deepseek-v2-lite-16b@2x2x2": dict(
        arch="deepseek-v2-lite-16b", weights="deepseek-v2-lite-16b",
        mesh=(2, 2, 2), train=2, prefill=True, serve=(B,), s_max=S_MAX),
}
_MEMO = {}


def _memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _weights(key):
    """JAX's smoke weights as numpy; Hymba's ``conv_b`` drawn N(0, 0.5)
    but in JAX's own serve case (its init is zero, as JAX's, which would
    hide a wrong slice of it, and leaves it at the size of Adam's first
    steps, where the steps' float32 rounding is the leaf's own scale)."""
    def make():
        arch, ov = WEIGHTS[key]
        cfg = jax_get_config(arch, smoke=True, **ov)
        tree = jax.tree.map(np.asarray, jax.jit(jax_build_model(cfg).init)(
            jax.random.PRNGKey(0)))
        if cfg.family == "hybrid" and key != "hymba-jax":
            rng = np.random.default_rng(1)
            for seg in tree["segments"]:
                seg["ssm"]["conv_b"] = rng.normal(
                    0, 0.5, seg["ssm"]["conv_b"].shape).astype(np.float32)
        return tree
    return _memo(("w", key), make)


def _inputs(key):
    """Tokens and labels (B, S); the encoder-decoder's frames (B, S, D)
    and the serve steps' ``enc_out`` (B, S_MAX, D)."""
    arch, ov = WEIGHTS[key]
    cfg = get_config(arch, smoke=True, **ov)
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(0, 1, (B, S, cfg.d_model)).astype(
            np.float32)
        out["enc_out"] = rng.normal(0, 1, (B, S_MAX, cfg.d_model)).astype(
            np.float32)
    return out


def _jcfg(key):
    arch, ov = WEIGHTS[key]
    return jax_get_config(arch, smoke=True, kernel_mode="ref", **ov)


def _jbatch(key, drop=("enc_out",)):
    return {k: jnp.asarray(v) for k, v in _inputs(key).items()
            if k not in drop}


def _jax_train(key):
    def make():
        step = jax.jit(jsteps.make_train_step(_jcfg(key)))
        params = jax.tree.map(jnp.asarray, _weights(key))
        state = jsteps.default_optimizer().init(params)
        batch = _jbatch(key)
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
                               _jbatch(key, ("enc_out", "labels"))))
    return _memo(("prefill", key), make)


def _jax_serve(key, batch, s_max, feed_zeros):
    def make():
        cfg = _jcfg(key)
        step = jax.jit(jsteps.make_serve_step(cfg))
        params = jax.tree.map(jnp.asarray, _weights(key))
        cache = jax_build_model(cfg).cache_init(batch, s_max)
        inp = _inputs(key)
        extra = (jnp.asarray(inp["enc_out"][:batch]),) \
            if "enc_out" in inp else ()
        tok = jnp.zeros((batch,), jnp.int32) if feed_zeros \
            else jnp.asarray(inp["tokens"][:batch, 0])
        pos = jnp.zeros((batch,), jnp.int32)
        logits, tokens = [], []
        for _ in range(2):
            lg, cache = step(params, cache, tok, pos, *extra)
            logits.append(np.asarray(lg))
            greedy = jnp.argmax(lg, -1).astype(jnp.int32)
            tokens.append(np.asarray(greedy).tolist())
            if not feed_zeros:
                tok = greedy
            pos = pos + 1
        return logits, tokens, jax.tree.map(np.asarray, cache)
    return _memo(("serve", key, batch, s_max, feed_zeros), make)


def _serve_ref(name):
    case = CASES[name]
    return _jax_serve(case["weights"], case["serve"][0], case["s_max"],
                      case.get("feed_zeros", False))


def _warm_jax():
    for case in CASES.values():
        if case.get("train"):
            _jax_train(case["weights"])
        if case.get("prefill"):
            _jax_prefill(case["weights"])
    for name, case in CASES.items():
        if case.get("serve"):
            _serve_ref(name)


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


def _members(name):
    return int(np.prod(CASES[name]["mesh"]))


def _coords(name, r):
    """((the rank's slot over the batch axes, its slot over ``model``),
    the batch axes' slots, ``model``'s slots)."""
    *dp, m = CASES[name]["mesh"]
    return divmod(r, m), int(np.prod(dp)), m


# -- eight ranks ------------------------------------------------------------------


def test_spawned_ranks_load_no_jax(ranks):
    _, raw = ranks
    assert len(raw) == WORLD and not any(r["jax_loaded"] for r in raw)


def _close_leaves(got, want, name):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), name
    for k, wv in w.items():
        wv = np.asarray(wv)
        scale = float(np.abs(wv).max())
        err = float(np.abs(g[k] - wv).max())
        assert err <= LEAF_TOL * scale, (name, k, err, scale)


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n].get("train")])
def test_train_steps_match_jax(ranks, name):
    out, _ = ranks
    metrics, params, m = _jax_train(CASES[name]["weights"])
    for r in range(_members(name)):
        got = out[r][name]["train"]
        assert got["step"] == 2
        for (loss, gn), (jl, jg) in zip(got["metrics"], metrics):
            assert abs(loss - jl) <= LOSS_RTOL * abs(jl), (r, loss, jl)
            assert abs(gn - jg) <= LOSS_RTOL * abs(jg), (r, gn, jg)
    got = out[0][name]["train"]
    _close_leaves(got["params"], params, name)
    _close_leaves(got["m"], m, name)


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n].get("train")])
def test_each_rank_holds_only_its_shards(ranks, name):
    out, _ = ranks
    for r in range(_members(name)):
        assert out[r][name]["train"]["bad_shards"] == [], r


def test_recomputed_encdec_layers_keep_the_step_shards(ranks):
    """A backward run outside the step's context recomputes each remat'd
    encoder and decoder layer on the same shards: the gradients equal a
    backward inside it."""
    out, _ = ranks
    for r in range(WORLD):
        inside, outside = out[r]["seamless-m4t-large-v2@2x4"]["train"][
            "backward_outside"]
        assert outside == inside, r


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n].get("prefill")])
def test_prefill_step_matches_jax(ranks, name):
    """The logits over the whole vocab, or the encoder output (B, S, D),
    each rank's rows of them."""
    out, _ = ranks
    want = _jax_prefill(CASES[name]["weights"])
    for r in range(_members(name)):
        (i, _), d, _ = _coords(name, r)
        n = B // d
        got = out[r][name]["prefill"]
        assert got.shape == (n,) + want.shape[1:]
        np.testing.assert_allclose(got, want[i * n:(i + 1) * n], rtol=0,
                                   atol=LOGIT_ATOL)


def _serve_atol(case):
    """RWKV's logits and states against JAX's: 1e-4, the logit tolerance
    of ``tests/test_torch_recurrent.py``.  Its norms magnify a float32
    sum taken in another order: here the unsharded port is already
    1.9e-5 off JAX's logits at the second serve step and 1.55e-5 off its
    channel-mix shift state, and the sharded logits 1.5e-5 off the
    unsharded port's."""
    return RWKV_ATOL if case["arch"] == RWKV else LOGIT_ATOL


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n].get("serve")])
def test_serve_steps_match_jax(ranks, name):
    """Each rank's logits shard is JAX's out sharding (``P(dp if B
    divides, "model" if V divides)``) of JAX's logits; the greedy tokens
    and the gathered cache or state equal JAX's."""
    out, _ = ranks
    case = CASES[name]
    batch, s_max = case["serve"][0], case["s_max"]
    logits, tokens, cache = _serve_ref(name)
    vocab = logits[0].shape[1]
    for r in range(_members(name)):
        (i, j), d, m = _coords(name, r)
        got = out[r][name][f"serve_{batch}"]
        rows = slice(i * batch // d, (i + 1) * batch // d) \
            if batch % d == 0 else slice(0, batch)
        cols = slice(j * vocab // m, (j + 1) * vocab // m) \
            if vocab % m == 0 else slice(0, vocab)
        assert got["tokens"] == tokens, r
        for g, w in zip(got["logits"], logits):
            assert g.shape == w[rows, cols].shape, r
            np.testing.assert_allclose(g, w[rows, cols], rtol=0,
                                       atol=_serve_atol(case))
        local = got["cache_k_local"]         # (layers, B, ...)
        if local is None:                     # RWKV: no attention cache
            assert case["arch"] == "rwkv6-1.6b"
        elif batch % d:                       # cut on its sequence
            assert local[1] == batch and s_max // d in local[2:]
        else:
            assert local[1] == batch // d and s_max in local[2:]
    got = _flat(out[0][name][f"serve_{batch}"]["cache_tree"])
    want = _flat(cache)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=_serve_atol(case), err_msg=k)


def test_act_sp_keeps_hymba_w_bcdt_an_all_reduce(ranks):
    """Under ``act_sp`` the SSM's ``w_bcdt`` partial product (trap 3),
    which is not the residual stream, is still summed whole over
    ``model``: one all-reduce of (B, S, 2N + dt_rank) a layer, as
    without it; the stream's sums are reduce-scattered."""
    out, _ = ranks
    cfg = get_config("hymba-1.5b", smoke=True)
    shape = (B // 2, S, 2 * cfg.ssm_state + cfg.dt_rank)
    for r in range(WORLD):
        for name, cut in (("hymba-1.5b@2x4", False),
                          ("hymba-1.5b+sp@2x4", True)):
            calls = out[r][name]["prefill_collectives"]
            bcdt = [c for c in calls if c.kind == "all_reduce"
                    and c.axis == "model" and c.shape == shape]
            assert len(bcdt) == cfg.n_layers, (name, r)
            scatters = [c for c in calls if c.kind == "reduce_scatter"]
            assert bool(scatters) == cut, (name, r)


def test_jax_hymba_serve_case_runs_as_written(ranks):
    """``tests/test_distributed.py``'s case: finite logits at position 1
    on every rank, each its shard of the (8, 512) logits."""
    out, _ = ranks
    for r in range(WORLD):
        lg = out[r]["hymba-jax-serve@2x4"]["serve_8"]["logits"]
        assert lg[1].shape == (4, 128) and np.isfinite(lg[1]).all(), r


def test_mla_batch_of_three_cuts_the_latent_cache_on_its_sequence(ranks):
    out, _ = ranks
    for name in ("minicpm3-batch3@2x4", "deepseek-batch3@2x4"):
        for r in range(WORLD):
            local = out[r][name]["serve_3"]["cache_k_local"]
            assert local[1:3] == (3, S_MAX // 2), (name, r, local)


def test_straddling_ranks_attend_their_heads_group_by_group(ranks):
    """25 query heads of 8 over 5 KV heads, ``wo``'s 200 rows cut in
    four: rank 0 attends heads 0-6 over KV heads 0-1, rank 1 heads 6-12
    over 1-2."""
    out, _ = ranks
    got = [out[r]["hymba-straddle@1x4"]["heads"] for r in range(4)]
    assert got == [(0, 7, 0, 2), (6, 13, 1, 3), (12, 19, 2, 4),
                   (18, 25, 3, 5)]


# -- the head arithmetic at full width (no ranks) -------------------------------


class _Line:
    """A ``model`` line of ``n`` slots seen from slot ``j``: what
    ``StepShards`` asks of a rank mesh."""

    def __init__(self, n, j):
        self.n, self.j = n, j

    def axis_group(self, axis):
        return None, tuple(range(self.n))

    def axis_index(self, axis):
        return self.j


@pytest.mark.parametrize("j,want,calls", [
    (0, (0, 7, 0, 2), [(0, 5, 0), (5, 7, 1)]),
    (1, (6, 13, 1, 3), [(0, 4, 1), (4, 7, 2)]),
    (2, (12, 19, 2, 4), [(0, 3, 2), (3, 7, 3)]),
    (3, (18, 25, 3, 5), [(0, 2, 3), (2, 7, 4)])])
def test_hymba_full_width_heads_at_model_four(j, want, calls):
    """hymba-1.5b's wo (1600 rows) on a model line of four: each rank's
    query heads and KV heads, and the attention calls ``_per_group``
    makes (query heads [a, b) of the rank's over one KV head)."""
    cfg = get_config("hymba-1.5b")
    wo = torch.empty((cfg.n_heads * cfg.hd, cfg.d_model), device="meta")
    shards = sharding.StepShards(_Line(4, j), {id(wo): {"model": 0}})
    with sharding.step_shards(shards):
        hs = attention.heads(cfg, type("P", (), {"wo": wo}))
    assert (hs.h0, hs.h1, hs.kv0, hs.kv1) == want
    made = []

    def fn(q, k, v):
        made.append((int(q[0, 0]), int(q[0, 0]) + q.shape[1],
                     int(k[0, 0])))
        return q
    q = torch.arange(hs.h1 - hs.h0)[None, :]
    k = torch.arange(hs.kv0, hs.kv1)[None, :]
    out = attention._per_group(cfg, hs, fn, q, k, k)
    assert made == calls and torch.equal(out, q)


# -- a world of one ---------------------------------------------------------------


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_debug_mesh((1, 1), ("data", "model"), ranks=True)
    finally:
        dist.destroy_process_group()


def _t(inp, *keys):
    return {k: torch.from_numpy(inp[k]) for k in keys if k in inp}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_steps_are_bit_equal(world_of_one, arch):
    """The sharded steps on a (1, 1) mesh compute what the unsharded
    steps compute, bit for bit (``chip_smoke.py`` phase 15 (c) at full
    width on the card), from ``init_shards``' weights."""
    mesh, inp = world_of_one, _inputs(arch)
    cfg = get_config(arch, smoke=True)
    bundle = steps.build_model(cfg, device="cpu")
    a = bundle.init(torch.Generator().manual_seed(0))
    b = steps.init_shards(cfg, torch.Generator().manual_seed(0), mesh)
    batch = _t(inp, "tokens", "frames")
    want = steps.make_prefill_step(cfg, device="cpu")(a, batch)
    step, _ = steps.shard_prefill_step(cfg, mesh, InputShape("p", S, B, "p"))
    assert torch.equal(step(b, batch), want)
    ca, cb = bundle.cache_init(B, S_MAX), bundle.cache_init(B, S_MAX)
    ref = steps.make_serve_step(cfg, device="cpu")
    step, _ = steps.shard_serve_step(cfg, mesh,
                                     InputShape("d", S_MAX, B, "decode"))
    extra = tuple(_t(inp, "enc_out").values())
    tok, pos = batch["tokens"][:, 0], torch.zeros(B, dtype=torch.int32)
    for _ in range(2):
        la, ca = ref(a, ca, tok, pos, *extra)
        lb, cb = step(b, cb, tok, pos, *extra)
        assert torch.equal(la, lb)
        tok, pos = la.argmax(-1).to(torch.int32), pos + 1
    for x, y in zip(_flat(ca).values(), _flat(cb).values()):
        assert torch.equal(x, y)
    cfg = get_config(arch, smoke=True, kernel_mode="ref")
    a = bundle.init(torch.Generator().manual_seed(0), dtype=cfg.pdtype)
    b = steps.init_shards(cfg, torch.Generator().manual_seed(0), mesh,
                          dtype=cfg.pdtype)
    opt = steps.default_optimizer()
    sa, sb = opt.init(a), opt.init(b)
    ref = steps.make_train_step(cfg, opt, device="cpu")
    step, _ = steps.shard_train_step(cfg, mesh, InputShape("t", S, B, "t"),
                                     optimizer=opt)
    batch = _t(inp, "tokens", "labels", "frames")
    for _ in range(2):
        a, sa, ma = ref(a, sa, batch)
        b, sb, mb = step(b, sb, batch)
        assert float(ma["loss"]) == float(mb["loss"])
        assert float(ma["grad_norm"]) == float(mb["grad_norm"])
    for (n, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), n


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shards_draws_what_one_card_draws(world_of_one, arch):
    cfg = get_config(arch, smoke=True)
    want = steps.build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    got = steps.init_shards(cfg, torch.Generator().manual_seed(3),
                            world_of_one)
    for (n, x), (m, y) in zip(want.named_parameters(),
                              got.named_parameters()):
        assert n == m and x.dtype == y.dtype and torch.equal(x, y), n
