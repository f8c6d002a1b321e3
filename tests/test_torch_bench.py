"""Parity of the port's benchmark library (``repro_torch.bench``) and of
its suite and shape configs with the JAX package's, on the CPU.

The same inputs go through ``repro.bench`` and ``repro_torch.bench``:
the committed ``benchmarks/baseline/BENCH_*.json`` reports and seeded
mutations of them (schema problems, diff findings and their rendered
text, with and without an allowlist), the same cells and results
(reports apart from ``meta.backend``, CSV lines), the same bad cell
lists and coordinates.  A report written by either package's
``run_axis`` validates under the other's schema.  ``measure`` is held
to its contract on a CPU callable.
"""

import copy
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.bench as jb
import repro_torch.bench as tb
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import long_context_ok as jax_long_context_ok
from repro.configs.dae_paper import DAE_SUITE as JAX_DAE_SUITE
from repro.configs.shapes import SUBQUADRATIC_ARCHS as JAX_SUBQUADRATIC
from repro_torch.bench import timing as ttiming
from repro_torch.configs import SHAPES, InputShape, long_context_ok
from repro_torch.configs.dae_paper import DAE_SUITE
from repro_torch.configs.shapes import SUBQUADRATIC_ARCHS
from repro_torch.core.workloads import BENCHMARKS, CONFIGS

ROOT = Path(__file__).resolve().parents[1]
BASELINES = sorted((ROOT / "benchmarks" / "baseline").glob("BENCH_*.json"))
ALLOWLIST = (ROOT / "benchmarks" / "diff_allowlist.txt").read_text()


def _load(path):
    return json.loads(path.read_text())


def _findings(fs):
    return [(dataclasses.astuple(f), f.fails, f.render()) for f in fs]


# -- the package surface ------------------------------------------------------


def test_exports_every_reference_name():
    assert set(jb.__all__) <= set(tb.__all__)
    for name in jb.__all__:
        assert hasattr(tb, name), name
    assert {"ColdTimer", "binsearch_data"} <= set(tb.__all__)
    assert tb.SCHEMA_VERSION == jb.SCHEMA_VERSION == 2
    assert tb.COORD_KEYS == jb.COORD_KEYS and tb.KINDS == jb.KINDS
    assert tb.FAIL_KINDS == jb.FAIL_KINDS
    assert tb.diffing.NOTE_KINDS == jb.diffing.NOTE_KINDS


# -- schema -------------------------------------------------------------------


def _set(path, value):
    def mutate(r, rng):
        node = r
        for key in path[:-1]:
            node = node[key if not callable(key) else key(node, rng)]
        last = path[-1]
        node[last if not callable(last) else last(node, rng)] = value
    return mutate


def _drop(path):
    def mutate(r, rng):
        node = r
        for key in path[:-1]:
            node = node[key if not callable(key) else key(node, rng)]
        last = path[-1]
        del node[last if not callable(last) else last(node, rng)]
    return mutate


def _cell(node, rng):
    return int(rng.integers(len(node)))


def _any_derived(node, rng):
    keys = sorted(node)
    return keys[int(rng.integers(len(keys)))] if keys else "added"


def _dup_name(r, rng):
    i, j = 0, len(r["cells"]) - 1
    r["cells"][j]["name"] = r["cells"][i]["name"]


def _cold_only(r, rng):
    c = r["cells"][_cell(r["cells"], rng)]
    c["us_cold"], c["us_warm"] = 12.5, None


def _empty_ok(r, rng):
    c = r["cells"][_cell(r["cells"], rng)]
    c.update(status="ok", cycles=None, us_warm=None, us_cold=None,
             derived={})


SCHEMA_MUTATIONS = {
    "valid": lambda r, rng: None,
    "not_a_dict": None,
    "missing_schema": _drop(["schema"]),
    "missing_meta": _drop(["meta"]),
    "missing_cells": _drop(["cells"]),
    "empty_cells": _set(["cells"], []),
    "old_schema": _set(["schema"], 1),
    "empty_axis": _set(["axis"], ""),
    "smoke_str": _set(["smoke"], "yes"),
    "seed_str": _set(["meta", "seed"], "0"),
    "backend_int": _set(["meta", "backend"], 7),
    "missing_status": _drop(["cells", _cell, "status"]),
    "bad_status": _set(["cells", _cell, "status"], "crashed"),
    "missing_group": _drop(["cells", _cell, "group"]),
    "missing_name": _drop(["cells", _cell, "name"]),
    "cell_not_dict": _set(["cells", _cell], 3),
    "coords_not_dict": _set(["cells", _cell, "coords"], []),
    "missing_coord": _drop(["cells", _cell, "coords", "engine"]),
    "extra_coord": _set(["cells", _cell, "coords", "host"], "x"),
    "bad_kind": _set(["cells", _cell, "coords", "kind"], "train"),
    "zero_tenants": _set(["cells", _cell, "coords", "tenants"], 0),
    "bool_tenants": _set(["cells", _cell, "coords", "tenants"], True),
    "bad_tuned": _set(["cells", _cell, "coords", "tuned"], "yes"),
    "empty_backend": _set(["cells", _cell, "coords", "backend"], ""),
    "negative_cycles": _set(["cells", _cell, "cycles"], -1),
    "float_cycles": _set(["cells", _cell, "cycles"], 1.5),
    "warm_str": _set(["cells", _cell, "us_warm"], "fast"),
    "negative_warm": _set(["cells", _cell, "us_warm"], -2.0),
    "cold_only": _cold_only,
    "derived_list": _set(["cells", _cell, "derived"], [1]),
    "derived_nested": _set(["cells", _cell, "derived", _any_derived],
                           {"a": 1}),
    "replay_list": _set(["cells", _cell, "replay"], [1]),
    "duplicate_name": _dup_name,
    "empty_ok_cell": _empty_ok,
}


@pytest.mark.parametrize("mutation", sorted(SCHEMA_MUTATIONS))
@pytest.mark.parametrize("path", BASELINES, ids=lambda p: p.stem)
def test_schema_problems_match_jax(path, mutation):
    report = _load(path)
    rng = np.random.default_rng(len(mutation))
    if SCHEMA_MUTATIONS[mutation] is None:
        report = report["cells"]
    else:
        SCHEMA_MUTATIONS[mutation](report, rng)
    want = jb.schema_problems(copy.deepcopy(report))
    got = tb.schema_problems(copy.deepcopy(report))
    assert got == want
    assert (mutation == "valid") == (not got)
    if got:
        with pytest.raises(tb.SchemaError) as err:
            tb.validate_report(report)
        assert err.value.problems == want
        assert str(err.value) == str(jb.SchemaError(want))
    else:
        assert tb.validate_report(report) is report


# -- diffing ------------------------------------------------------------------


def _pick(cells, rng, pred):
    idx = [i for i, c in enumerate(cells) if pred(c)]
    return cells[idx[int(rng.integers(len(idx)))]] if idx else None


def _bump_cycles(delta):
    def mutate(r, rng):
        c = _pick(r["cells"], rng, lambda c: c.get("cycles") is not None)
        if c is None:
            c = r["cells"][0]
            c["cycles"] = 100
        elif delta is None:
            c["cycles"] = None
        else:
            c["cycles"] += delta
    return mutate


def _bump_int_derived(r, rng):
    def has_int(c):
        return any(isinstance(v, int) and not isinstance(v, bool)
                   for v in c["derived"].values())
    c = _pick(r["cells"], rng, has_int)
    if c is None:
        r["cells"][0]["derived"]["added"] = 3
        return
    key = sorted(k for k, v in c["derived"].items()
                 if isinstance(v, int) and not isinstance(v, bool))[0]
    c["derived"][key] += 1


def _float_derived(r, rng):
    r["cells"][0]["derived"]["rate"] = 1.5       # floats are informational


def _scale_wall(factor):
    def mutate(r, rng):
        c = _pick(r["cells"], rng, lambda c: c.get("us_warm"))
        if c is None:
            for c in r["cells"]:
                c["us_warm"] = 100.0 * factor
        else:
            c["us_warm"] *= factor
    return mutate


def _remove_cell(r, rng):
    r["cells"].pop(int(rng.integers(len(r["cells"]))))


def _new_cell(r, rng):
    cell = copy.deepcopy(r["cells"][0])
    cell["name"] = cell["name"] + "/new"
    r["cells"].append(cell)


def _change_coords(r, rng):
    r["cells"][_cell(r["cells"], rng)]["coords"]["tenants"] += 1


def _change_status(r, rng):
    c = r["cells"][_cell(r["cells"], rng)]
    c["status"] = "deadlock" if c["status"] == "ok" else "ok"


def _many(r, rng):
    for m in (_bump_cycles(3), _bump_int_derived, _scale_wall(2.0),
              _remove_cell, _new_cell, _change_coords):
        m(r, rng)


DIFF_MUTATIONS = {
    "same": lambda r, rng: None,
    "cycles_up": _bump_cycles(5),
    "cycles_down": _bump_cycles(-2),
    "cycles_gone": _bump_cycles(None),
    "derived_int": _bump_int_derived,
    "derived_float": _float_derived,
    "wall_slower": _scale_wall(1.6),
    "wall_faster": _scale_wall(0.5),
    "wall_in_band": _scale_wall(1.1),
    "removed_cell": _remove_cell,
    "new_cell": _new_cell,
    "coords": _change_coords,
    "status": _change_status,
    "smoke_mismatch": lambda r, rng: r.update(smoke=not r["smoke"]),
    "axis_mismatch": lambda r, rng: r.update(axis=r["axis"] + "x"),
    "many": _many,
}
ALLOWLISTS = {"none": "", "repo": ALLOWLIST,
              "patterns": "# intentional\n*/table1/*   # sim rows\n"
                          "serve/serve/parity/*\nkernels/kernel/*/rif=2\n"}


@pytest.mark.parametrize("allow", sorted(ALLOWLISTS))
@pytest.mark.parametrize("mutation", sorted(DIFF_MUTATIONS))
@pytest.mark.parametrize("path", BASELINES, ids=lambda p: p.stem)
def test_diff_findings_match_jax(path, mutation, allow):
    base = _load(path)
    fresh = copy.deepcopy(base)
    DIFF_MUTATIONS[mutation](fresh, np.random.default_rng(7))
    patterns = tb.parse_allowlist(ALLOWLISTS[allow])
    assert patterns == jb.parse_allowlist(ALLOWLISTS[allow])
    want = jb.diff_reports(base, fresh, allowlist=patterns)
    got = tb.diff_reports(base, fresh, allowlist=patterns)
    assert _findings(got) == _findings(want)
    assert _findings(tb.regressions(got)) == _findings(jb.regressions(want))
    if mutation == "same":
        assert got == []
    if mutation in ("wall_in_band", "derived_float"):
        assert not tb.regressions(got)
    if mutation == "removed_cell":
        assert [f.kind for f in got] == ["removed-cell"]


def test_diff_wall_band_is_25_percent():
    base = _load(ROOT / "benchmarks" / "baseline" / "BENCH_compile.json")
    for factor, kinds in ((1.24, []), (1.26, ["wall-clock"]),
                          (0.76, []), (0.74, ["wall-clock-improved"])):
        fresh = copy.deepcopy(base)
        fresh["cells"][0]["us_warm"] = base["cells"][0]["us_warm"] * factor
        assert [f.kind for f in tb.diff_reports(base, fresh)] == kinds
        assert _findings(tb.diff_reports(base, fresh, wall_pct=10.0)) == \
            _findings(jb.diff_reports(base, fresh, wall_pct=10.0))


# -- registry, report, matrix -------------------------------------------------


RESULTS = [
    ("sim/a", dict(workload="binsearch", kind="sim"),
     dict(cycles=1234, derived={"golden": 7})),
    ("kernel/b", dict(workload="gather", kind="kernel", engine="kernel",
                      backend="cuda:sm90", tuned=False),
     dict(us_cold=1234.56789, us_warm=98.7654, derived={"rows": 256,
                                                        "gbs": 1.23456})),
    ("serve/c", dict(workload="serve-granite-34b", kind="serve",
                     engine="kernel", backend="torch:cpu", tenants=8,
                     tuned=False),
     dict(us_warm=5.0e6, derived={"tokens": 256, "tok_s": 31.25,
                                  "match": True, "loop": "paged"})),
    ("sim/dead", dict(workload="hashtable", kind="sim"),
     dict(status="deadlock", cycles=99)),
]


def _cells(pkg, axis="x"):
    out = []
    for name, kw, res in RESULTS:
        c = pkg.Cell(axis=axis, name=name, coords=pkg.coords(**kw),
                     run=lambda ctx, res=res: pkg.CellResult(**res),
                     group="g" + name[0])
        out.append(c)
    return out


def _no_backend(report):
    report = copy.deepcopy(report)
    report["meta"].pop("backend")
    return report


def test_coords_and_results_match_jax():
    for _, kw, res in RESULTS:
        assert tb.coords(**kw) == jb.coords(**kw)
        assert tb.CellResult(**res).to_json() == jb.CellResult(**res).to_json()
    assert tb.CellResult(us_cold=1.26, us_warm=0.04).to_json()["us_warm"] \
        == 0.0
    for bad in (dict(workload="w", kind="train"), dict(workload="",
                                                       kind="sim"),
                dict(workload="w", kind="sim", tenants=0)):
        with pytest.raises(ValueError) as want:
            jb.coords(**bad)
        with pytest.raises(ValueError) as got:
            tb.coords(**bad)
        assert str(got.value) == str(want.value)
    assert tb.BenchContext(smoke=True).sim_scale == "small"
    assert tb.BenchContext().sim_scale == "paper"


@pytest.mark.parametrize("smoke", [False, True])
def test_build_report_and_csv_match_jax(smoke):
    ctx_t, ctx_j = tb.BenchContext(smoke=smoke, seed=3), \
        jb.BenchContext(smoke=smoke, seed=3)
    got_rows = tb.run_cells(_cells(tb), ctx_t)
    want_rows = jb.run_cells(_cells(jb), ctx_j)
    got = tb.build_report("x", got_rows, smoke=smoke, seed=3)
    want = jb.build_report("x", want_rows, smoke=smoke, seed=3)
    assert _no_backend(got) == _no_backend(want)
    assert got["meta"]["backend"] == "torch:cpu"
    assert [tb.cell_csv(c, r) for c, r in got_rows] == \
        [jb.cell_csv(c, r) for c, r in want_rows]
    assert tb.cell_csv(*got_rows[3]) == "sim/dead,0,status=deadlock;cycles=99"
    assert tb.bench_path("serve", Path("d")) == jb.bench_path("serve",
                                                             Path("d"))


def test_run_cells_rejects_a_non_result():
    bad = tb.Cell(axis="x", name="n", coords=tb.coords("w", "sim"),
                  run=lambda ctx: {"cycles": 1})
    with pytest.raises(TypeError, match="expected CellResult"):
        tb.run_cells([bad], tb.BenchContext())


def test_reports_cross_validate(tmp_path):
    """A report of the port's ``run_axis`` passes JAX's ``load_report``
    and the reverse; both print the same CSV stream."""
    lines = {"port": [], "jax": []}
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    mine = tb.run_axis("serve", _cells(tb, "serve"), tb.BenchContext(seed=1),
                       out_dir=tmp_path / "port",
                       csv_print=lines["port"].append)
    ref = jb.run_axis("serve", _cells(jb, "serve"), jb.BenchContext(seed=1),
                      out_dir=tmp_path / "jax", csv_print=lines["jax"].append)
    assert lines["port"] == lines["jax"]
    assert lines["port"][-1] == "matrix/serve/bench_json,0,path=" \
        "BENCH_serve.json;cells=4"
    assert jb.load_report(tmp_path / "port" / "BENCH_serve.json") == mine
    assert tb.load_report(tmp_path / "jax" / "BENCH_serve.json") == ref
    assert not tb.diff_reports(ref, mine)
    assert not jb.diff_reports(mine, ref)


def test_load_report_rejects_a_malformed_file(tmp_path):
    path = tmp_path / "BENCH_x.json"
    path.write_text(json.dumps({"schema": 2, "axis": "x"}))
    with pytest.raises(tb.SchemaError):
        tb.load_report(path)
    with pytest.raises(tb.SchemaError):
        tb.write_report({"schema": 2}, path)


def _cell_lists(pkg):
    ok = lambda name, axis="x": pkg.Cell(  # noqa: E731
        axis=axis, name=name, coords=pkg.coords("w", "sim"),
        run=lambda ctx: None)
    missing = pkg.Cell(axis="x", name="m", coords={"workload": "w"},
                       run=lambda ctx: None)
    return {"mixed_axes": [ok("a"), ok("b", axis="y")],
            "duplicate": [ok("a"), ok("a")],
            "missing_coords": [ok("a"), missing]}


@pytest.mark.parametrize("case", ["mixed_axes", "duplicate",
                                  "missing_coords"])
def test_check_cells_rejects_as_jax(case):
    with pytest.raises(ValueError) as want:
        jb.check_cells(_cell_lists(jb)[case], "x")
    with pytest.raises(ValueError) as got:
        tb.check_cells(_cell_lists(tb)[case], "x")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        tb.run_axis("x", _cell_lists(tb)[case], tb.BenchContext(),
                    out_dir=Path("unused"))


# -- timing -------------------------------------------------------------------


@pytest.mark.parametrize("warm_reps", [0, 1, 3])
def test_measure_times_a_cpu_callable(warm_reps):
    calls = []

    def fn():
        calls.append(1)
        return {"x": torch.ones(3), "y": [torch.zeros(2), (1, "a")]}

    t = tb.measure(fn, warm_reps=warm_reps)
    assert isinstance(t, tb.Timing)
    assert isinstance(t.us_cold, float) and isinstance(t.us_warm, float)
    assert t.us_cold > 0 and t.us_warm > 0
    assert len(calls) == 1 + max(1, warm_reps)
    assert dataclasses.asdict(t).keys() == {"us_cold", "us_warm"}


def test_measure_synchronises_a_card_result(monkeypatch):
    """Each timed call whose result holds a CUDA tensor is synchronised
    before the clock is read; a CPU result is not."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: syncs.append(1))
    tb.measure(lambda: torch.ones(2), warm_reps=2)
    assert syncs == []
    monkeypatch.setattr(ttiming, "_on_card", lambda result: True)
    tb.measure(lambda: torch.ones(2), warm_reps=2)
    assert len(syncs) == 3


@dataclasses.dataclass
class _Out:
    logits: object
    extra: object = None


def test_on_card_walks_containers():
    cpu = torch.ones(2)
    for result in (cpu, [cpu], (1, [cpu]), {"a": {"b": cpu}}, _Out(cpu),
                   _Out(None, [cpu]), None, 3, "x", _Out):
        assert ttiming._on_card(result) is False


# -- configs ------------------------------------------------------------------


def test_dae_suite_matches_jax():
    assert DAE_SUITE == JAX_DAE_SUITE
    assert DAE_SUITE["benchmarks"] == BENCHMARKS
    assert DAE_SUITE["configs"] == CONFIGS


def test_shapes_match_jax():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, shape in SHAPES.items():
        assert isinstance(shape, InputShape)
        assert dataclasses.asdict(shape) == \
            dataclasses.asdict(JAX_SHAPES[name])
    assert SUBQUADRATIC_ARCHS == JAX_SUBQUADRATIC
    for arch in ("qwen3-4b", "granite-34b", "rwkv6-1.6b", "hymba-1.5b"):
        assert long_context_ok(arch) == jax_long_context_ok(arch)
