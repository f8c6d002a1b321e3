"""Parity of the port's DAE model (``repro_torch.core``: ``dae``,
``simulator``, ``channels.sim``, ``trace``, ``waveform``, ``workloads``)
with the JAX package's, on the CPU.

The model is pure Python, so the port's copy must reproduce the
reference exactly: cycles, stored values, per-instance accounting,
``TraceSummary`` JSON, VCD text and deadlock messages, cell by cell over
``tests/test_parity.py``'s grids and over seeded random programs from
``tests/strategies.py``, which the port instantiates with its own
classes.  Every comparison is exact.
"""

import json
import random
import types
from pathlib import Path

import pytest

import strategies
from repro.core import simulator as jsim
from repro.core import workloads as jwl
from repro.core.waveform import WaveformTracer as JaxWaveformTracer
from repro_torch.core import dae as tdae
from repro_torch.core import simulator as tsim
from repro_torch.core import workloads as twl
from repro_torch.core.trace import Tracer
from repro_torch.core.waveform import WaveformTracer
from test_parity import MULTI_GRID, SINGLE_GRID

GOLDEN = Path(__file__).parent / "golden"
SMALL = dict(scale="small", latency=100)


def _report(r):
    """Every observable field of a WorkloadReport."""
    return (r.cycles, r.golden, r.overhead, r.correct, r.mem_reads,
            json.dumps(r.trace.to_json(), sort_keys=True))


@pytest.mark.parametrize("bench,config,mem,rif,cap", SINGLE_GRID)
def test_single_cells_match_reference(bench, config, mem, rif, cap):
    kw = dict(mem=mem, rif=rif, cap_slack=cap, trace=True, **SMALL)
    want = _report(jwl.run_workload(bench, config, **kw))
    assert _report(twl.run_workload(bench, config, **kw)) == want


@pytest.mark.parametrize("bench,config,mem,rif,cap", SINGLE_GRID)
def test_port_engines_agree(bench, config, mem, rif, cap):
    kw = dict(mem=mem, rif=rif, cap_slack=cap, trace=True, **SMALL)
    assert _report(twl.run_workload(bench, config, engine="polling", **kw)) \
        == _report(twl.run_workload(bench, config, engine="event", **kw))


@pytest.mark.parametrize("bench,config,mem,n", MULTI_GRID)
def test_multi_cells_match_reference(bench, config, mem, n):
    kw = dict(mem=mem, rif=8, max_outstanding=64, trace=True, **SMALL)
    want = jwl.run_workload_multi(bench, config, n, **kw)
    got = twl.run_workload_multi(bench, config, n, **kw)
    assert got.cycles == want.cycles
    assert got.per_instance_cycles == want.per_instance_cycles
    assert got.mem_reads == want.mem_reads
    assert got.correct == want.correct
    assert json.dumps(got.trace.to_json(), sort_keys=True) == \
        json.dumps(want.trace.to_json(), sort_keys=True)


@pytest.mark.parametrize("engine", ["event", "polling"])
@pytest.mark.parametrize("case", ["cap_slack", "rhls_stream_mergesort"])
def test_deadlocks_match_reference(case, engine):
    """§5.3: capacity below the RIF, and the R-HLS-Stream merge sort,
    raise the port's DeadlockError with the reference's message."""
    def run(wl):
        if case == "cap_slack":
            return wl.run_workload_multi("hashtable", "rhls_dec", 2, rif=8,
                                         cap_slack=-4, engine=engine,
                                         **SMALL)
        return wl.run_workload("mergesort", "rhls_stream", engine=engine,
                               **SMALL)
    with pytest.raises(tsim.DeadlockError) as got:
        run(twl)
    with pytest.raises(jsim.DeadlockError) as want:
        run(jwl)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("benchmark", twl.BENCHMARKS)
def test_golden_traces(benchmark):
    report = twl.run_workload(benchmark, "rhls_dec", scale="small",
                              latency=100, rif=8, trace=True,
                              trace_bin_cycles=64)
    assert report.correct
    want = json.loads((GOLDEN / f"{benchmark}.json").read_text())
    assert report.trace.to_json() == want


def test_waveform_vcd_matches_reference():
    vcds = []
    for wl, tracer in ((jwl, JaxWaveformTracer(64)), (twl, WaveformTracer(64))):
        wl.run_workload("binsearch", "rhls_dec", scale="small", latency=100,
                        rif=8, tracer=tracer)
        vcds.append(tracer.to_vcd())
    assert vcds[0] and vcds[1] == vcds[0]


# -- seeded random programs, the port's classes --------------------------------

# strategies.build_program / build_engine_inputs rebound to the port's
# classes: the same generator code, so a spec builds the same program in
# both packages
_PORT_NAMES = dict(vars(strategies))
_PORT_NAMES.update({name: getattr(tdae, name) for name in (
    "DaeProgram", "Delay", "Deq", "Enq", "LoadChannel", "Process", "Req",
    "Resp", "Store", "StoreWait", "StreamChannel")})
_PORT_NAMES.update({name: getattr(tsim, name) for name in (
    "EngineInstance", "FixedLatencyMemory", "Fused", "Par")})
build_program = types.FunctionType(strategies.build_program.__code__,
                                   _PORT_NAMES, "build_program",
                                   strategies.build_program.__defaults__)
_PORT_NAMES["build_program"] = build_program
build_engine_inputs = types.FunctionType(
    strategies.build_engine_inputs.__code__, _PORT_NAMES,
    "build_engine_inputs")


def _single(sim, build, tracer, spec):
    prog, mems = build(spec)
    try:
        r = sim.simulate(prog, mems, tracer=tracer)
    except Exception as e:                      # noqa: BLE001 — compared
        return type(e).__name__, str(e)
    return (r.cycles, r.stores, r.counts, r.mem_reads,
            r.stored_array("out", max(1, spec["n_stores"])),
            json.dumps(tracer.summary().to_json(), sort_keys=True))


def _multi(sim, build, tracer, spec, n):
    instances, shared = build(spec, n)
    try:
        res = sim.SharedMemoryEngine(instances, shared, tracer=tracer).run()
    except Exception as e:                      # noqa: BLE001 — compared
        return type(e).__name__, str(e)
    return (res.cycles, res.events, res.passes,
            [(r.cycles, r.stores, r.counts, r.mem_reads)
             for r in res.instances],
            json.dumps(tracer.summary().to_json(), sort_keys=True))


@pytest.mark.parametrize("seed", range(40))
def test_random_programs_match_reference(seed):
    from repro.core.trace import Tracer as JaxTracer
    spec = strategies.random_spec(random.Random(seed))
    assert _single(tsim, build_program, Tracer(bin_cycles=32), spec) == \
        _single(jsim, strategies.build_program, JaxTracer(bin_cycles=32),
                spec)
    assert _multi(tsim, build_engine_inputs, Tracer(bin_cycles=32), spec,
                  3) == \
        _multi(jsim, strategies.build_engine_inputs,
               JaxTracer(bin_cycles=32), spec, 3)
