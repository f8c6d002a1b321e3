"""The port's tuner (``repro_torch.tune``) on the CPU, beside the JAX
package's ``repro.tune``: the cache, the spaces, the searchers, the
simulator-backed workload tuning and the compiler's cached plans.

Where both packages can run the same thing here they are held equal:
the configurations ``search`` visits, in order, and their scores on the
same synthetic measure; ``tune_workload``'s winner, cycles and evals
(the two simulators are bit-identical); ``program_key_parts``; the
plans ``infer_plans`` takes from a winner planted under each package's
own key.  Wall-clock tuning on the CPU times the kernels' plain versions
(``device="cpu"``): only its plumbing is checked here.  Every
comparison is exact.
"""

import json
import math
import threading

import numpy as np
import pytest
import torch

import repro.compile as jc
import repro.compile.targets as jt
import repro.core.simulator as jsim
import repro.tune as jtune
from repro.tune.search import search as jax_search
from repro.tune.space import SearchSpace as JaxSearchSpace
import repro_torch.compile as tc
import repro_torch.compile.targets as tt
import repro_torch.core.simulator as tsim
import repro_torch.tune as tune
import repro_torch.tune.runners as runners
from repro_torch.kernels import common
from repro_torch.tune import (CacheEntry, TuneCache, cache_path,
                              default_cache, dispatch_config, kernel_space,
                              make_key, reset_default_cache, tune_kernel,
                              tune_workload, wallclock_tag, workload_space)
from repro_torch.tune.search import hill_climb, search
from repro_torch.tune.space import SearchSpace

JAX_TAGS = ("interpret", "cpu", "tpu", "gpu", "sim")
TARGETS = sorted(tt.COMPILE_TARGETS)


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "tune_cache.json"
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(path))
    reset_default_cache()
    jtune.reset_default_cache()
    yield path
    reset_default_cache()
    jtune.reset_default_cache()


# -- the cache ----------------------------------------------------------------


def test_cache_roundtrip_identical_config(tmp_cache):
    key = make_key("dae_gather", (4096, 256, 512), torch.float32,
                   "torch:cpu", "wallclock")
    cfg = {"method": "rif", "chunk": 32, "rif": 16}
    TuneCache(tmp_cache).put(key, CacheEntry(config=cfg, score=1.5e-3,
                                             baseline_score=2.0e-3, evals=9))
    fresh = TuneCache(tmp_cache)  # separate instance -> reads from disk
    hit = fresh.get(key)
    assert hit is not None and hit.config == cfg
    assert hit.score == 1.5e-3 and hit.baseline_score == 2.0e-3
    assert fresh.hits == 1 and fresh.misses == 0
    assert fresh.get("nope|1|float32|torch:cpu|wallclock") is None
    assert fresh.misses == 1
    raw = json.loads(tmp_cache.read_text())
    assert raw["version"] == 1
    assert raw["entries"][key]["config"] == cfg


@pytest.mark.parametrize("text", ["{not json", "[]", '{"version": 2}',
                                  '{"version": 1, "entries": {"k": 3}}', ""])
def test_cache_survives_corrupt_file(tmp_cache, text):
    tmp_cache.write_text(text)
    c = TuneCache(tmp_cache)
    assert len(c) == 0  # corrupt == empty, never raises
    c.put("k", CacheEntry(config={"a": 1}, score=1.0))
    assert TuneCache(tmp_cache).get("k").config == {"a": 1}


def test_cache_path_honours_env(tmp_cache, tmp_path, monkeypatch):
    assert cache_path() == tmp_cache
    assert default_cache().path == tmp_cache
    # the singleton follows the path, as the reference's does
    other = tmp_path / "other.json"
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(other))
    assert default_cache().path == other
    monkeypatch.delenv("REPRO_TUNE_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert cache_path() == tmp_path / "xdg" / "repro" / "tune_cache.json"
    assert cache_path() == jtune.cache_path()


def test_lookups_after_the_first_read_no_file(tmp_cache, monkeypatch):
    key = make_key("dae_merge", (4, 4), "float32", "torch:cpu", "wallclock")
    TuneCache(tmp_cache).put(key, CacheEntry(config={"tile": 64}, score=1.0))
    assert dispatch_config("dae_merge", (4, 4), torch.float32,
                           "cpu") == {"tile": 64}

    def no_read(self, *a, **k):
        raise AssertionError("the cache file was read again")
    monkeypatch.setattr(type(tmp_cache), "read_text", no_read)
    for _ in range(3):
        assert dispatch_config("dae_merge", (4, 4), torch.float32,
                               "cpu") == {"tile": 64}


@pytest.mark.parametrize("second_better", [False, True])
def test_concurrent_saves_merge_and_keep_the_better_score(tmp_cache,
                                                          second_better):
    a = TuneCache(tmp_cache)
    b = TuneCache(tmp_cache)
    a.put("op_a", CacheEntry(config={"rif": 8}, score=1.0))   # saves
    b.put("op_b", CacheEntry(config={"rif": 16}, score=2.0))  # saves
    merged = TuneCache(tmp_cache)
    assert merged.get("op_a").config == {"rif": 8}
    assert merged.get("op_b").config == {"rif": 16}
    a.save()
    assert a.get("op_b").config == {"rif": 16}
    # a key both tuned: the lower score wins, whichever saved last
    a.put("op", CacheEntry(config={"rif": 8}, score=5.0))
    b.put("op", CacheEntry(config={"rif": 32}, score=3.0))
    if second_better:
        a.put("op", CacheEntry(config={"rif": 8}, score=5.0))
    assert TuneCache(tmp_cache).get("op").config == {"rif": 32}


# -- key hygiene --------------------------------------------------------------


def test_port_tags_are_never_the_references(monkeypatch):
    assert common.backend_tag("cpu") == "torch:cpu"
    assert runners.SIM_BACKEND == "torch:sim"
    # a card's tag, from its compute capability (an H100 is 9.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda index=None: (9, 0))
    common._capability.cache_clear()
    try:
        assert common.backend_tag(torch.device("cuda", 0)) == "cuda:sm90"
    finally:
        common._capability.cache_clear()
    for tag in ("torch:cpu", "cuda:sm90", runners.SIM_BACKEND):
        assert tag not in JAX_TAGS


@pytest.mark.parametrize("torch_dtype,np_dtype", [
    (torch.bfloat16, "bfloat16"), (torch.float32, np.float32),
    (torch.int32, np.int32)])
def test_dtypes_are_keyed_as_the_reference_keys_them(torch_dtype, np_dtype):
    import jax.numpy as jnp
    want = jtune.make_key("op", (2, 3), str(jnp.dtype(np_dtype)),
                          "torch:cpu", "wallclock")
    assert make_key("op", (2, 3), torch_dtype, "torch:cpu",
                    "wallclock") == want
    assert make_key("op", (2, 3), np.dtype(np_dtype), "torch:cpu",
                    "wallclock") == want
    assert "torch." not in want


def test_a_reference_entry_never_dispatches_a_port_kernel(tmp_cache):
    """Both packages share one file; the reference's key for the same
    (op, dims, dtype) carries its own backend tag."""
    dims = (64, 64)
    jkey = jtune.make_key("dae_merge", dims, "float32",
                          jtune.backend_tag(True), "wallclock")
    jtune.default_cache().put(jkey, jtune.CacheEntry(config={"tile": 64},
                                                     score=1.0))
    assert jtune.dispatch_config("dae_merge", dims, "float32",
                                 True) == {"tile": 64}
    reset_default_cache()
    assert jkey in default_cache()
    assert dispatch_config("dae_merge", dims, torch.float32, "cpu") == {}


def test_dispatch_config_misses_without_a_backend(tmp_cache, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dispatch_config("dae_gather", (8, 8, 8), "float32", None) == {}
    assert dispatch_config("dae_gather", (8, 8, 8), "float32", "cpu") == {}


# -- spaces -------------------------------------------------------------------


def test_space_snap_and_neighbours():
    sp = SearchSpace("t", {"rif": (2, 4, 8, 16), "tile": (128, 256)},
                     {"rif": 4, "tile": 128})
    assert sp.size == 8
    assert sp.snap({"rif": 5, "tile": 9999, "junk": 1}) == \
        {"rif": 4, "tile": 256}
    assert sp.snap({"rif": 3}) == {"rif": 2, "tile": 128}
    ns = list(sp.neighbours({"rif": 4, "tile": 128}))
    assert ns == [{"rif": 2, "tile": 128}, {"rif": 8, "tile": 128},
                  {"rif": 4, "tile": 256}]
    jsp = JaxSearchSpace("t", dict(sp.params), dict(sp.seed))
    assert list(jsp.neighbours({"rif": 4, "tile": 128})) == ns
    assert list(jsp.grid()) == list(sp.grid())


# the card shapes chip_smoke's phase 8 tunes at, beside KERNEL_DIMS
CARD_DIMS = {
    "dae_gather": (151_936, 2560, 256),
    "dae_merge": (1 << 23, 1 << 23),
    "flash_attention": (2048, 2048, 64),
    "flash_decode": (1024, 128),
    "flash_decode_paged": (16, 128),
    "grouped_matmul": (8320, 2048, 1408),
    "batched_searchsorted": (1 << 27, 1 << 22),
    "hash_lookup": (1 << 24, 1 << 20),
    "dae_spmv": (8192, 1 << 24, 1 << 16),
}


@pytest.mark.parametrize("dims", ["kernel", "card"])
@pytest.mark.parametrize("op", sorted(runners.KERNEL_DIMS))
def test_kernel_space_seed_on_grid_and_names_the_references(op, dims):
    d = runners.KERNEL_DIMS[op] if dims == "kernel" else CARD_DIMS[op]
    sp = kernel_space(op, *d)
    assert sp.name == op and sp.seed == sp.snap(sp.seed)
    for k, v in sp.seed.items():
        assert v in sp.params[k], (op, k, v)
    jsp = jtune.kernel_space(op, *d)
    # the reference's knob names, less those without a Hopper
    # counterpart; the prefill tunes its ring depth in their place
    extra = {"flash_attention": {"rif"}}.get(op, set())
    assert set(sp.params) - extra <= set(jsp.params)
    for k, vs in sp.params.items():
        assert list(vs) == sorted(vs) or k == "method"
        if k == "rif":
            assert max(vs) <= 16


def test_port_limits_cut_the_grids():
    assert kernel_space("batched_searchsorted", 4096, 256).params["rif"] \
        == (1, 2, 4)
    assert kernel_space("dae_merge", 2048, 2048).params["rif"] == (1, 2, 4)
    assert kernel_space("flash_decode_paged", 16, 128).params["rif"] == \
        (4, 8, 16)
    # four warps' K and V stages of bk bf16 keys at D 128 fit up to 64
    assert kernel_space("flash_decode", 1024, 128).params["bk"] == \
        (16, 32, 64)
    assert kernel_space("grouped_matmul", 256, 256, 256).params["bf"] == \
        (128, 256)
    assert "rif" not in kernel_space("hash_lookup", 4096, 256).params


@pytest.mark.parametrize("latency", [20, 100, 400])
@pytest.mark.parametrize("bench", ["hashtable", "binsearch"])
def test_workload_space_equals_the_references(bench, latency):
    sp = workload_space(bench, latency=latency)
    jsp = jtune.workload_space(bench, latency=latency)
    assert (sp.name, dict(sp.params), sp.seed) == \
        (jsp.name, dict(jsp.params), jsp.seed)
    assert sp.seed["cap_slack"] >= 1     # legacy-safe, deadlock-free seed


# -- searchers ----------------------------------------------------------------


def _quadratic(cfg):
    return (cfg["x"] - 6) ** 2 + (cfg["y"] - 3) ** 2


def _deadlocking(err):
    def measure(cfg):
        if cfg["x"] < 2:
            raise err("undersized capacity")
        return _quadratic(cfg)
    return measure


@pytest.mark.parametrize("seed", [{"x": 0, "y": 0}, {"x": 2, "y": 1},
                                  {"x": 9, "y": 4}])
@pytest.mark.parametrize("strategy,max_evals", [
    ("grid", 50), ("grid", 7), ("hill", 40), ("hill", 5), ("auto", 64),
    ("auto", 12)])
@pytest.mark.parametrize("deadlock", [False, True])
def test_search_visits_what_the_reference_visits(seed, strategy, max_evals,
                                                 deadlock):
    params = {"x": tuple(range(10)), "y": tuple(range(5))}
    sp = SearchSpace("q", params, seed)
    jsp = JaxSearchSpace("q", params, seed)
    mine = _deadlocking(tsim.DeadlockError) if deadlock else _quadratic
    ref = _deadlocking(jsim.DeadlockError) if deadlock else _quadratic
    got = search(sp, mine, max_evals=max_evals, strategy=strategy)
    want = jax_search(jsp, ref, max_evals=max_evals, strategy=strategy)
    assert got.trace == want.trace
    assert (got.best, got.best_score, got.seed, got.seed_score,
            got.evals) == (want.best, want.best_score, want.seed,
                           want.seed_score, want.evals)


def test_hill_climb_descends_from_seed():
    sp = SearchSpace("q", {"x": tuple(range(10)), "y": tuple(range(5))},
                     {"x": 2, "y": 1})
    res = hill_climb(sp, _quadratic, max_evals=40)
    assert res.best == {"x": 6, "y": 3}
    assert res.improvement == math.inf  # best_score hit exact 0


def test_search_penalizes_deadlock():
    sp = SearchSpace("d", {"x": (0, 1, 2, 3)}, {"x": 1})

    def measure(cfg):
        if cfg["x"] < 2:
            raise tsim.DeadlockError("undersized capacity")
        return float(cfg["x"])

    res = search(sp, measure, max_evals=16, strategy="grid")
    assert res.best == {"x": 2} and res.best_score == 2.0
    assert not math.isfinite(res.seed_score)


# -- workload tuning: the same winners, cycles and evals as the reference -----


@pytest.mark.parametrize("bench,latency,instances,max_evals,strategy", [
    ("hashtable", 100, 1, 32, "auto"),
    ("binsearch", 100, 1, 32, "auto"),
    ("spmv", 100, 1, 32, "auto"),
    ("mergesort_opt", 100, 1, 32, "auto"),
    ("hashtable", 100, 4, 32, "auto"),
    # cells where the search moves off the seed
    ("binsearch", 20, 1, 32, "auto"),
    ("spmv", 20, 1, 32, "auto"),
    ("mergesort_opt", 20, 1, 8, "auto"),
    # the grid's first points deadlock (cap_slack -4)
    ("hashtable", 20, 1, 12, "grid"),
])
def test_tune_workload_matches_the_reference(tmp_cache, bench, latency,
                                             instances, max_evals, strategy):
    kw = dict(scale="small", latency=latency, instances=instances,
              max_evals=max_evals, strategy=strategy)
    want = jtune.tune_workload(bench, "rhls_dec", **kw)
    got = tune_workload(bench, "rhls_dec", **kw)
    assert got.evals > 0
    assert (got.best, got.best_score, got.seed_score, got.evals) == \
        (want.best, want.best_score, want.seed_score, want.evals)
    assert got.trace == want.trace
    again = tune_workload(bench, "rhls_dec", **kw)
    assert again.evals == 0  # cache hit: no re-measurement
    assert again.best == got.best and again.best_score == got.best_score
    assert again.seed_score == got.seed_score


def test_cap_slack_reproduces_deadlock():
    from repro_torch.core.workloads import run_workload
    with pytest.raises(tsim.DeadlockError):
        run_workload("hashtable", "rhls_dec", scale="small", latency=20,
                     rif=8, cap_slack=-4)


# -- wall-clock plumbing on the CPU -------------------------------------------


def test_wallclock_tag_solo_and_contended():
    assert wallclock_tag(1) == "wallclock"
    assert wallclock_tag(4) == "wallclock:contenders=4"


def test_kernel_runner_rejects_nonpositive_contenders():
    with pytest.raises(ValueError, match="contenders"):
        runners.kernel_runner("dae_merge", (64, 64), device="cpu",
                              contenders=0)


def test_time_callable_contended_dispatches_concurrently():
    """On the CPU the makespan path must run all N contenders at once:
    each call parks on a 2-party barrier, so sequential execution would
    time the barrier out instead of passing."""
    barrier = threading.Barrier(2)

    def fn():
        barrier.wait(timeout=30)

    assert runners.time_callable(fn, reps=2, contenders=2,
                                 device="cpu") >= 0.0


@pytest.mark.parametrize("op", sorted(runners.KERNEL_DIMS))
def test_tune_kernel_on_the_cpu_persists_and_hits(tmp_cache, op):
    res = tune_kernel(op, device="cpu", max_evals=3, reps=1)
    assert res.evals == min(3, kernel_space(op, *runners.KERNEL_DIMS[op])
                            .size)
    assert math.isfinite(res.best_score) and res.best_score <= \
        res.seed_score
    key, _ = runners.kernel_key(op, device="cpu")
    assert key.split("|")[2:] == [runners.KERNEL_DTYPES[op], "torch:cpu",
                                  "wallclock"]
    assert default_cache().get(key).config == res.best
    again = tune_kernel(op, device="cpu")
    assert again.evals == 0 and again.best == res.best


def test_tune_kernel_contended_keys_and_winner_divergence(tmp_cache,
                                                          monkeypatch):
    """``contenders=N`` persists under its own key, and a contention
    profile that penalizes what solo rewards yields another winner (a
    deterministic stand-in measure shaped like the §5.4 regime)."""
    def fake_gmm_measure(dims, device, reps, contenders=1):
        def measure(cfg):
            target = 256 if contenders <= 1 else 128
            return abs(cfg["bf"] - target) + cfg["rif"] * 1e-3
        return measure

    monkeypatch.setitem(runners._KERNEL_MEASURES, "grouped_matmul",
                        fake_gmm_measure)
    dims = (256, 512, 256)
    solo = tune_kernel("grouped_matmul", dims, device="cpu", max_evals=40)
    duo = tune_kernel("grouped_matmul", dims, device="cpu", max_evals=40,
                      contenders=2)
    assert solo.best == {"bf": 256, "rif": 1}
    assert duo.best == {"bf": 128, "rif": 1}
    k1, _ = runners.kernel_key("grouped_matmul", dims, device="cpu")
    k2, _ = runners.kernel_key("grouped_matmul", dims, device="cpu",
                               contenders=2)
    assert k1 != k2 and k2.endswith("wallclock:contenders=2")
    assert default_cache().get(k2).note == "wallclock:contenders=2"
    assert dispatch_config("grouped_matmul", dims, torch.bfloat16,
                           "cpu")["bf"] == 256
    assert dispatch_config("grouped_matmul", dims, torch.bfloat16, "cpu",
                           mem=wallclock_tag(2))["bf"] == 128


def test_spmv_winner_is_written_under_its_alias_key(tmp_cache):
    dims = (32, 128, 60)
    res = tune_kernel("dae_spmv", dims, device="cpu", max_evals=4)
    measure, key, _ = runners.kernel_runner("dae_spmv", dims, device="cpu")
    (alias,) = measure.alias_keys(res.best)
    assert alias != key
    entry = default_cache().get(alias)
    assert entry.config == res.best and entry.note == "wallclock-alias"


# -- the compiler: program keys and cached plans ------------------------------


@pytest.mark.parametrize("name", TARGETS)
def test_program_key_parts_match_the_reference(name):
    j, t = jt.build_target(name), tt.build_target(name)
    assert tc.program_key_parts(tc.elaborate(t.prog, t.memories)) == \
        jc.program_key_parts(jc.elaborate(j.prog, j.memories))


@pytest.mark.parametrize("config", [{"chunk": 16, "rif": 3},
                                    {"chunk": 8, "rif": 1},
                                    {"rif": 5}, {"chunk": 32}])
@pytest.mark.parametrize("name", TARGETS)
def test_infer_takes_the_cached_winner_as_the_reference_does(tmp_cache, name,
                                                             config):
    j, t = jt.build_target(name), tt.build_target(name)
    jir = jc.elaborate(j.prog, j.memories)
    ir = tc.elaborate(t.prog, t.memories)
    op, dims, dtype = jc.program_key_parts(jir)
    jtune.default_cache().put(
        jtune.make_key(op, dims, dtype, jtune.backend_tag(True),
                       "wallclock"), jtune.CacheEntry(config=config,
                                                      score=1.0))
    default_cache().put(make_key(op, dims, dtype, "torch:cpu", "wallclock"),
                        CacheEntry(config=config, score=1.0))
    want = jc.infer_plans(jir, interpret=True)
    got = tc.infer_plans(ir, device="cpu")
    assert [vars(p) for p in got.values()] == \
        [vars(p) for p in want.values()]
    assert all("cache" in p.source for p in got.values())
    ck = tc.compile_program(t.prog, t.memories, chase=t.chase, device="cpu")
    assert [vars(p) for p in ck.plans.values()] == \
        [vars(p) for p in want.values()]
    tt.assert_parity(ck(), j.simulate_oracle())


@pytest.mark.parametrize("name", TARGETS)
def test_compiled_runner_builds_what_compile_program_builds(name):
    """The runner elaborates and checks once, then re-runs infer and
    codegen per point: the plans and outputs equal compile_program's at
    the same knobs."""
    measure, key, dims = runners.compiled_runner(name, device="cpu")
    t = tt.build_target(name)
    assert key == make_key(*tc.program_key_parts(
        tc.elaborate(t.prog, t.memories)), "torch:cpu", "wallclock")
    for cfg in ({"chunk": 8, "rif": 1}, {"chunk": 64, "rif": 16}):
        ck = measure.compiled(cfg)
        want = tc.compile_program(t.prog, t.memories, chase=t.chase,
                                  device="cpu", **cfg)
        assert [vars(p) for p in ck.plans.values()] == \
            [vars(p) for p in want.plans.values()]
        got, ref = ck(), want()
        assert got.keys() == ref.keys()
        for port in ref:
            np.testing.assert_array_equal(got[port], ref[port])
        assert measure(cfg) >= 0.0


def test_tune_compiled_persists_and_dispatches(tmp_cache):
    res = tune.tune_compiled("gather", device="cpu", max_evals=3, reps=1)
    assert res.evals == 3 and math.isfinite(res.best_score)
    again = tune.tune_compiled("gather", device="cpu")
    assert again.evals == 0 and again.best == res.best
    ck, t = tt.compile_target("gather", device="cpu")
    plans = list(ck.plans.values())
    assert all(p.source == "cache" for p in plans)
    assert all(p.chunk == min(res.best["chunk"], 33) for p in plans)
    tt.assert_parity(ck(), t.simulate_oracle())
