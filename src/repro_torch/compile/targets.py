"""Named compile targets: workload programs wired up for the compiler.

Each target builds the *same* DAE program the simulator runs (from
:mod:`repro_torch.core.workloads`), packages the plain port data for
:func:`repro_torch.compile.compile_program`, and knows how to produce the
simulator oracle for differential parity.  This module is what the
parity tests, ``benchmarks/compile_bench`` and ``tune_compiled`` all
drive — one registry, no per-consumer re-wiring.

Targets:

  ``gather``          STATIC stream; comparable with the hand-written
                      ``dae_gather`` family.
  ``frontier_gather`` one INDIRECT hop (``dist[adj[...]]``); has NO
                      hand-written kernel — the compile-only proof.
  ``binsearch``       DEPENDENT stream + ChaseSpec (early-exit variant;
                      the spec carries Listing 5's lock-step form and
                      the check pass proves it reproduces the
                      round-robin simulator's stores).
  ``binsearch_for``   as above, fixed-iteration variant.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.compile import chase as ops
from repro_torch.compile.ir import ChaseSpec

__all__ = ["COMPILE_TARGETS", "BuiltTarget", "build_target",
           "compile_target", "assert_parity"]


@dataclasses.dataclass
class BuiltTarget:
    """One target instance: program + data + (maybe) chase semantics."""

    name: str
    prog: Any                          # DaeProgram (rebuildable)
    memories: Dict[str, List[Any]]     # plain copies, safe to stage
    chase: Optional[ChaseSpec]
    out_lens: Dict[str, int]
    _oracle: Callable[[], Dict[str, np.ndarray]]

    def simulate_oracle(self) -> Dict[str, np.ndarray]:
        """Run the event-driven simulator on a fresh build and return
        its stored output ports as dense arrays."""
        return self._oracle()


def _mem_factory(latency: int):
    from repro_torch.core.simulator import FixedLatencyMemory

    def make(port: str, data: Any):
        return FixedLatencyMemory(data, latency=latency)
    return make


def _oracle_from_phases(build_phases: Callable[[], Any],
                        out_lens: Dict[str, int]
                        ) -> Callable[[], Dict[str, np.ndarray]]:
    def run() -> Dict[str, np.ndarray]:
        from repro_torch.core.simulator import simulate
        progs, mems, _golden, check = build_phases()
        result = None
        for prog in progs:
            result = simulate(prog, mems)
        assert result is not None and check(result), \
            "simulator self-check failed (oracle invalid)"
        outs: Dict[str, np.ndarray] = {}
        for port, n in out_lens.items():
            got = result.stored_array(port, n)
            if got and isinstance(got[0], np.ndarray):
                outs[port] = np.stack(got)
            else:
                outs[port] = np.asarray([-1 if g is None else g
                                         for g in got])
        return outs
    return run


def _binsearch_chase(data: Dict[str, Any], early: bool) -> ChaseSpec:
    """The binsearch loop as a ChaseSpec: the twin of the ``fixed_step``
    closure in ``_binsearch_phases`` (Listing 5's lock-step form — check
    proves it equals the early-exit trace), written in the ops of
    :mod:`repro_torch.compile.chase` where the reference uses jnp."""
    arr, keys, n = data["arr"], data["keys"], int(data["n"])
    iters = int(math.ceil(math.log2(n)))
    m = len(keys)
    state0 = np.zeros((m, 5), np.int32)          # (i, key, lo, hi, res)
    state0[:, 0] = np.arange(m)
    state0[:, 1] = keys
    state0[:, 3] = n
    state0[:, 4] = -1

    def _mid(lo, hi):
        return ops.where(lo < hi, (lo + hi) // 2, ops.minimum(lo, n - 1))

    def addr_fn(s):
        _i, _key, lo, hi, _res = s
        return _mid(lo, hi)

    def step_fn(s, row):
        i, key, lo, hi, res = s
        v = row[0]
        mid = _mid(lo, hi)
        if early:
            res = ops.where((v == key) & (res < 0), mid, res)
        take = lo < hi
        lo2 = ops.where(take & (v <= key), mid + 1, lo)
        hi2 = ops.where(take & (v > key), mid, hi)
        return (i, key, lo2, hi2, res)

    def out_fn(s):
        i, _key, lo, _hi, res = s
        return (i, res if early else lo)

    return ChaseSpec("table", state0, iters, addr_fn, step_fn, out_fn)


def _build_gather(scale: str, latency: int, rif: int) -> BuiltTarget:
    from repro_torch.core import workloads as wl

    data = wl.make_gather_data(scale)
    m = len(data["idx"])

    def phases():
        return wl.gather_phases(data, latency, rif, _mem_factory(latency))

    progs, mems, _g, _c = phases()
    return BuiltTarget(
        name="gather", prog=progs[0],
        memories={p: list(mem.data) for p, mem in mems.items()},
        chase=None, out_lens={"out": m},
        _oracle=_oracle_from_phases(phases, {"out": m}))


def _build_frontier(scale: str, latency: int, rif: int) -> BuiltTarget:
    from repro_torch.core import workloads as wl

    data = wl.make_frontier_data(scale)
    m = len(data["frontier"]) * data["deg"]

    def phases():
        return wl.frontier_phases(data, latency, rif,
                                  _mem_factory(latency))

    progs, mems, _g, _c = phases()
    return BuiltTarget(
        name="frontier_gather", prog=progs[0],
        memories={p: list(mem.data) for p, mem in mems.items()},
        chase=None, out_lens={"out": m},
        _oracle=_oracle_from_phases(phases, {"out": m}))


def _build_spmv_gather(scale: str, latency: int, rif: int) -> BuiltTarget:
    from repro_torch.core import workloads as wl

    data = wl.make_spmv_data(scale)
    m = data["nnz"]

    def phases():
        return wl.spmv_gather_phases(data, latency, rif,
                                     _mem_factory(latency))

    progs, mems, _g, _c = phases()
    return BuiltTarget(
        name="spmv_gather", prog=progs[0],
        memories={p: list(mem.data) for p, mem in mems.items()},
        chase=None, out_lens={"out": m},
        _oracle=_oracle_from_phases(phases, {"out": m}))


def _build_binsearch(scale: str, latency: int, rif: int, *,
                     early: bool) -> BuiltTarget:
    from repro_torch.core import workloads as wl

    data = wl.make_binsearch_data(scale)
    m = len(data["keys"])
    name = "binsearch" if early else "binsearch_for"

    def phases():
        return wl._binsearch_phases(data, "rhls_dec", early, latency,
                                    rif, _mem_factory(latency))

    progs, mems, _g, _c = phases()
    return BuiltTarget(
        name=name, prog=progs[0],
        memories={p: list(mem.data) for p, mem in mems.items()},
        chase=_binsearch_chase(data, early), out_lens={"out": m},
        _oracle=_oracle_from_phases(phases, {"out": m}))


COMPILE_TARGETS: Dict[str, Callable[..., BuiltTarget]] = {
    "gather": _build_gather,
    "frontier_gather": _build_frontier,
    "spmv_gather": _build_spmv_gather,
    "binsearch": lambda scale, latency, rif:
        _build_binsearch(scale, latency, rif, early=True),
    "binsearch_for": lambda scale, latency, rif:
        _build_binsearch(scale, latency, rif, early=False),
}


def build_target(name: str, scale: str = "small", *, latency: int = 100,
                 rif: int = 8) -> BuiltTarget:
    if name not in COMPILE_TARGETS:
        raise KeyError(f"unknown compile target {name!r}; have "
                       f"{sorted(COMPILE_TARGETS)}")
    return COMPILE_TARGETS[name](scale, latency, rif)


def compile_target(name: str, scale: str = "small", **kwargs):
    """Build + compile a named target in one call; returns
    ``(CompiledKernel, BuiltTarget)``."""
    from repro_torch.compile import compile_program

    t = build_target(name, scale)
    ck = compile_program(t.prog, t.memories, chase=t.chase, **kwargs)
    return ck, t


def assert_parity(compiled: Dict[str, np.ndarray],
                  oracle: Dict[str, np.ndarray]) -> None:
    """Bit-identity up to the documented staging cast: both sides are
    compared in float64, which is exact for every target's value range
    (ints < 2**31, float32 data float32 end-to-end)."""
    for port, want in oracle.items():
        got = compiled.get(port)
        assert got is not None, f"compiled output missing port {port!r}"
        assert got.shape == want.shape, (port, got.shape, want.shape)
        assert np.array_equal(got.astype(np.float64),
                              want.astype(np.float64)), \
            f"compiled-vs-simulator mismatch on port {port!r}"
