"""Parity of the port's DAE compiler (``repro_torch.compile``) with the
JAX package's ``repro.compile``, on the CPU.

The JAX package's ring kernels call ``pl.load``, which jax 0.9 no
longer has, so its compiled kernels cannot run here.  What can run is
held exactly: the elaborated IR, the plans for explicit knobs, the check
results and the rejection diagnostics.  The port's compiled kernels
(through their plain versions on the CPU) are held, as the reference's
own tests hold them, to the JAX simulator's stores, bit for bit in
float64 (``assert_parity``).  The chase tracer's register program, run
by the numpy model of the CUDA kernel's arithmetic, is held to the
spec's callables on random int32 states, at any state and row width
(``test_torch_chase_cpp.py`` holds the C++ emitted from it to that
model).  A B+-tree search of 16- and 32-word nodes, written as a DAE
program, is accepted by JAX's ``check`` and compiles to JAX's simulator
stores, from int32 and from int16 nodes.  Every comparison is exact.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.compile as jc
import repro.compile.targets as jt
import repro.core.dae as jdae
import repro.core.simulator as jsim
import repro_torch.compile as tc
import repro_torch.compile.targets as tt
import repro_torch.core.dae as tdae
import repro_torch.core.simulator as tsim
from repro_torch.compile import chase as cops
from repro_torch.kernels.compiled import kernel as rk
from repro_torch.kernels.ring import MAX_RIF
from strategies import random_spec
from test_torch_dae_model import build_program as port_build_program
from test_torch_gpu import _floor_spec as _gpu_floor_spec
from test_torch_gpu import _wide_spec
from repro_torch.bench.chases import (bptree_data, bptree_fns, bptree_program,
                                      bptree_state0, mix_fns)
import repro.compile.ir as jir
import repro.core.workloads as jwl
import repro_torch.compile.ir as tir
import repro_torch.core.workloads as twl
import strategies

TARGETS = sorted(tt.COMPILE_TARGETS)
ROOT = Path(__file__).resolve().parents[1]


def _ir_view(ir):
    """Everything the IR holds, as plain comparable values."""
    return {
        "name": ir.name,
        "channels": [(c.name, c.port, c.capacity, c.kind.value, c.addrs,
                      [np.asarray(v).tolist() for v in c.values], c.source,
                      c.offset) for c in ir.channels.values()],
        "stores": [(s.port, s.addr, np.asarray(s.value).tolist(), s.source,
                    s.const) for s in ir.stores],
        "ports": {k: (p.array.dtype.str, p.array.tolist())
                  for k, p in ir.ports.items()},
        "perturbed_ok": ir.perturbed_ok,
        "notes": list(ir.notes),
    }


@pytest.fixture(scope="module", params=TARGETS)
def built(request):
    name = request.param
    return name, jt.build_target(name), tt.build_target(name)


def test_targets_build_the_same_programs(built):
    _name, j, t = built
    assert t.memories.keys() == j.memories.keys()
    for port in j.memories:
        assert [np.asarray(v).tolist() for v in t.memories[port]] == \
            [np.asarray(v).tolist() for v in j.memories[port]]
    assert t.out_lens == j.out_lens
    assert (t.chase is None) == (j.chase is None)
    if j.chase is not None:
        np.testing.assert_array_equal(t.chase.state0, j.chase.state0)
        assert (t.chase.port, t.chase.max_steps, t.chase.out_port) == \
            (j.chase.port, j.chase.max_steps, j.chase.out_port)


def test_elaborate_matches_reference(built):
    _name, j, t = built
    assert _ir_view(tc.elaborate(t.prog, t.memories)) == \
        _ir_view(jc.elaborate(j.prog, j.memories))


@pytest.mark.parametrize("rif,chunk", [(1, 1), (4, 16), (9, 64), (16, 8)])
def test_infer_with_explicit_knobs_matches_reference(built, rif, chunk):
    _name, j, t = built
    want = jc.infer_plans(jc.elaborate(j.prog, j.memories), rif=rif,
                          chunk=chunk)
    got = tc.infer_plans(tc.elaborate(t.prog, t.memories), rif=rif,
                         chunk=chunk)
    assert [vars(p) for p in got.values()] == \
        [vars(p) for p in want.values()]


def test_check_matches_reference(built):
    _name, j, t = built
    want = jc.check(j.prog, jc.elaborate(j.prog, j.memories), chase=j.chase)
    got = tc.check(t.prog, tc.elaborate(t.prog, t.memories), chase=t.chase)
    assert (got.shape, got.out_specs, got.notes) == \
        (want.shape, want.out_specs, want.notes)


def test_compiled_target_matches_reference_simulator(built):
    name, j, _t = built
    ck, t = tt.compile_target(name, device="cpu")
    assert ck.device == torch.device("cpu")
    oracle = j.simulate_oracle()
    tt.assert_parity(ck(), oracle)
    tt.assert_parity(ck(), t.simulate_oracle())        # and re-runnable
    if name == "frontier_gather":
        assert ck.shape == "deref"


# -- edge regimes and the MAX_RIF clamp ----------------------------------------


def _tiny_gather(dae, sim, idx, table_len=16, cap=4):
    ch = dae.LoadChannel("t_load", capacity=cap, port="table")

    def access():
        for a in idx:
            yield dae.Req(ch, int(a))

    def execute():
        for j in range(len(idx)):
            yield sim.Fused(dae.Resp(ch), lambda v, j=j: dae.Store("out", j, v))

    prog = dae.DaeProgram("tiny", [dae.Process("access", access),
                                   dae.Process("execute", execute)])
    mems = {"table": [10 * i for i in range(table_len)],
            "out": [None] * max(1, len(idx))}
    return prog, mems


def test_rif_one_and_empty_stream():
    prog, mems = _tiny_gather(tdae, tsim, [3, 1, 2, 3])
    ck = tc.compile_program(prog, mems, rif=1, chunk=1, device="cpu")
    assert all(p.rif == 1 and p.chunk == 1 for p in ck.plans.values())
    np.testing.assert_array_equal(ck()["out"], [30, 10, 20, 30])
    prog, mems = _tiny_gather(tdae, tsim, [])
    assert tc.compile_program(prog, mems, device="cpu")() == {}


def test_rif_clamped_to_capacity_then_to_max_rif():
    prog, mems = _tiny_gather(tdae, tsim, [1, 2, 3, 0], cap=3)
    (plan,) = tc.compile_program(prog, mems, rif=64,
                                 device="cpu").plans.values()
    assert plan.rif == 3 and "5.3" in plan.note
    idx = list(range(16)) * 4
    prog, mems = _tiny_gather(tdae, tsim, idx, cap=100)
    ck = tc.compile_program(prog, mems, rif=40, chunk=64, device="cpu")
    (plan,) = ck.plans.values()
    assert plan.rif == MAX_RIF and "MAX_RIF" in plan.note
    assert plan.source == "explicit"
    assert f"rif={MAX_RIF}" in ck.describe()
    np.testing.assert_array_equal(ck()["out"], [10 * i for i in idx])


def test_default_plans_come_from_plan_rif():
    t = tt.build_target("gather")
    plans = tc.infer_plans(tc.elaborate(t.prog, t.memories))
    assert all(p.source == "plan_rif" and 1 <= p.rif <= MAX_RIF
               for p in plans.values())


def test_compile_program_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog, mems = _tiny_gather(tdae, tsim, [1, 2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.compile_program(prog, mems)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.compile_target("gather")


# -- reject-path diagnostics, word for word ------------------------------------


def _dependent(dae, sim):
    ch = dae.LoadChannel("walk", capacity=4, port="table")

    def proc():
        a = 0
        for _ in range(4):
            yield dae.Req(ch, a)
            a = int((yield dae.Resp(ch)))
        yield dae.Store("out", 0, a)

    return (dae.DaeProgram("chase", [dae.Process("walk", proc)]),
            {"table": [3, 0, 1, 2], "out": [None]}, {})


def _store_to_load_port(dae, sim):
    ch = dae.LoadChannel("ld", capacity=2, port="table")

    def proc():
        yield dae.Req(ch, 0)
        v = yield dae.Resp(ch)
        yield dae.Store("table", 1, v)

    return (dae.DaeProgram("raw", [dae.Process("p", proc)]),
            {"table": [5, 6], "out": [None]}, {})


def _out_of_range(dae, sim):
    prog, mems = _tiny_gather(dae, sim, [99])
    return prog, mems, {}


def _wrong_chase(dae, sim):
    targets = tt if dae is tdae else jt
    t = targets.build_target("binsearch")
    good = t.chase
    bad = type(good)(good.port, good.state0, good.max_steps, good.addr_fn,
                     good.step_fn, lambda s: (s[0], s[2] + 1))
    return t.prog, t.memories, {"chase": bad}


@pytest.mark.parametrize("case", [_dependent, _store_to_load_port,
                                  _out_of_range, _wrong_chase],
                         ids=lambda f: f.__name__.strip("_"))
def test_rejections_match_reference(case):
    prog, mems, kw = case(jdae, jsim)
    with pytest.raises(jc.CompileError) as want:
        jc.compile_program(prog, mems, **kw)
    prog, mems, kw = case(tdae, tsim)
    with pytest.raises(tc.CompileError) as got:
        tc.compile_program(prog, mems, device="cpu", **kw)
    assert got.value.pass_name == want.value.pass_name
    assert got.value.diagnostics == want.value.diagnostics
    assert str(got.value) == str(want.value)


def test_binsearch_without_chase_gives_the_chasespec_hint():
    t = tt.build_target("binsearch")
    with pytest.raises(tc.CompileError, match="Supply a ChaseSpec"):
        tc.compile_program(t.prog, t.memories, device="cpu")


# -- the 40 seeded random programs: compile or reject as the reference -------


@pytest.mark.parametrize("seed", range(40))
def test_random_programs_compile_or_reject_as_reference(seed):
    spec = random_spec(random.Random(seed))
    jprog, jmems = strategies.build_program(spec, name=f"rand{seed}")
    tprog, tmems = port_build_program(spec, name=f"rand{seed}")
    try:
        jck = jc.compile_program(jprog, jmems)
    except jc.CompileError as e:
        with pytest.raises(tc.CompileError) as got:
            tc.compile_program(tprog, tmems, device="cpu")
        assert got.value.diagnostics == e.diagnostics
        return
    ck = tc.compile_program(tprog, tmems, device="cpu")
    assert (ck.shape, ck.out_specs) == (jck.shape, jck.out_specs)
    outs = ck()
    prog2, mems2 = strategies.build_program(spec, name=f"rand{seed}")
    try:
        res = jsim.simulate(prog2, mems2)
    except jsim.DeadlockError:
        return                                # no oracle, as in the reference
    for addr, w in enumerate(res.stored_array("out",
                                              max(1, spec["n_stores"]))):
        if w is not None:
            np.testing.assert_array_equal(
                np.asarray(outs["out"][addr], dtype=np.float64),
                np.asarray(w, dtype=np.float64), err_msg=f"addr {addr}")


# -- the chase tracer -----------------------------------------------------------


def _wrap_spec():
    return (*_wide_spec(), 8, 8)


def _floor_spec():
    return (*_gpu_floor_spec(), 2, 1)


def _binsearch_spec():
    spec = tt.build_target("binsearch").chase
    return spec.addr_fn, spec.step_fn, spec.out_fn, spec.state_width, 1


def _mix(s, w):
    def spec():
        return (*mix_fns(s, w), s, w)
    spec.__name__ = f"_s{s}_w{w}_"
    return spec


# past the register path: S 9 and 12, W 9, 17 and 256 (whose program has
# more than 512 instructions)
_S9, _S12, _W9, _W17, _W256 = (_mix(9, 3), _mix(12, 5), _mix(4, 9),
                               _mix(3, 17), _mix(3, 256))


def _callables_numpy(addr_fn, step_fn, out_fn, port, state0, steps):
    """The spec's callables on numpy int32 columns (numpy's own int32
    wrap and floor division), Listing 5's lock-step walk."""
    n = port.shape[0]
    st = tuple(state0[:, j] for j in range(state0.shape[1]))
    with np.errstate(over="ignore"):
        for _ in range(steps):
            a = np.clip(np.asarray(addr_fn(st)), 0, n - 1)
            row = tuple(port[a, j] for j in range(port.shape[1]))
            st = tuple(np.broadcast_to(np.asarray(v), a.shape)
                       .astype(np.int32) for v in step_fn(st, row))
        return tuple(np.broadcast_to(np.asarray(v), (state0.shape[0],))
                     .astype(np.int32) for v in out_fn(st))


@pytest.mark.parametrize("spec", [_wrap_spec, _floor_spec, _binsearch_spec,
                                  _S9, _S12, _W9, _W17, _W256],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("seed", [0, 1])
def test_traced_program_equals_callables(spec, seed):
    """The register program the CUDA kernel is generated from, run by its
    numpy model, equals the callables on random int32 states, and so does
    the kernel's plain version: floor division of negatives and int32
    wrap included."""
    addr_fn, step_fn, out_fn, s, w = spec()
    rng = np.random.default_rng(seed)
    m, n, steps = 500, 1 << 12, 6
    port = rng.integers(-5000, 5000, (n, w)).astype(np.int32)
    state0 = rng.integers(-(1 << 31), 1 << 31, (m, s)).astype(np.int32)
    if spec is _binsearch_spec:
        port = np.sort(port, axis=0)
        state0[:, 2] = rng.integers(0, n // 2, m)       # 0 <= lo <= hi <= n
        state0[:, 3] = state0[:, 2] + rng.integers(0, n // 2, m)
    prog = cops.trace_chase(addr_fn, step_fn, out_fn, s, w)
    want = _callables_numpy(addr_fn, step_fn, out_fn, port, state0, steps)
    got = cops.run_numpy(prog, port, state0, steps)
    plain = rk.ring_chase_plain(torch.from_numpy(port),
                                torch.from_numpy(state0.reshape(-1)), prog,
                                max_steps=steps, s_width=s)
    for g, p, x in zip(got, plain, want):
        np.testing.assert_array_equal(g, x)
        np.testing.assert_array_equal(p.numpy(), x)
    assert rk.chase_register_path(s, w) == (s <= 8 and w <= 8)
    if spec is _W256:
        assert prog.n_instr > 512


def test_tracer_edge_semantics():
    """x // 0 and x % 0 are 0 (numpy's int32), INT_MIN // -1 wraps, a
    bool's ~ is logical and an int's bitwise, and the register file
    reuses dead values."""
    def addr_fn(s):
        return s[0]

    def step_fn(s, row):
        return (s[0] // s[1], s[0] % s[1], ~(s[0] < s[1]), ~s[1])

    state0 = np.array([[7, 0, 0, 0], [-2 ** 31, -1, 0, 0], [-7, 2, 0, 0]],
                      np.int32)
    port = np.zeros((1, 1), np.int32)
    for out_fn, want in (
            (lambda s: (s[0], s[1]), ([0, -2 ** 31, -4], [0, 0, 1])),
            (lambda s: (s[2], s[3]), ([1, 0, 0], [-1, 0, -3]))):
        prog = cops.trace_chase(addr_fn, step_fn, out_fn, 4, 1)
        got = cops.run_numpy(prog, port, state0, 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    big = cops.trace_chase(lambda s: s[0],
                           lambda s, r: tuple(s[0] + i for i in range(8)),
                           lambda s: (s[0], s[7]), 8, 1)
    assert big.n_regs <= 8 + 1 + 2


def test_tracer_rejects_what_the_kernel_cannot_run():
    """Only what no kernel can run: a Python truth value of a traced
    value, a constant outside int32, a callable of the wrong arity.  A
    state or row past 8 words traces (the shared-memory path runs it)."""
    with pytest.raises(TypeError, match="truth value"):
        cops.trace_chase(lambda s: 1 if s[0] > 0 else 0, lambda s, r: s,
                         lambda s: (0, 0), 1, 1)
    for s, w in ((9, 1), (1, 9), (64, 1024)):
        prog = cops.trace_chase(lambda s: 0, lambda s, r: s,
                                lambda s: (0, 0), s, w)
        assert not rk.chase_register_path(s, w)
        assert prog.s_width == s and prog.row_width == w
        assert len(prog.words) == cops.header_words(s) + 5 * prog.n_instr
    with pytest.raises(ValueError, match="does not fit int32"):
        cops.trace_chase(lambda s: s[0] + 2 ** 40, lambda s, r: s,
                         lambda s: (0, 0), 1, 1)
    with pytest.raises(ValueError, match="returned 1 values"):
        cops.trace_chase(lambda s: 0, lambda s, r: (s[0],),
                         lambda s: (0, 0), 2, 1)


def test_opcodes_and_limits_match_the_cuda_interpreter():
    """Every opcode the tracer emits has a C++ form in the generator of
    the kernel's functions, and the register path's thresholds, the
    shared-memory path's register budget for states and its opt-in are
    those of ``csrc/ring_chase.cuh``."""
    from repro_torch.core.pipeline import SMEM_OPTIN_BYTES
    src = (ROOT / "src/repro_torch/csrc/ring_chase.cuh").read_text()
    for name, op in cops.OPS.items():
        if name != "CONST":
            assert cops._expr(op, "x", "y", "z", None)
    for py, cu in ((rk.REG_STATE, "kRegState"), (rk.REG_ROW, "kRegRow"),
                   (rk.REG_STATE_WORDS, "kRegStateWords"),
                   (SMEM_OPTIN_BYTES, "kSmemOptin"),
                   (rk.CHASE_CTA_WARPS * 32, "kThreads")):
        assert int(re.search(rf"constexpr (?:int|long long) {cu} = (\d+);",
                             src).group(1)) == py


# -- wide rows: a B+-tree search as a DAE program -----------------------------


def _reference_stores(data):
    prog, mems, _spec = bptree_program(data, dae=jdae, wl=jwl, ir=jir)
    res = jsim.simulate(prog, {p: jsim.FixedLatencyMemory(v, latency=100)
                               for p, v in mems.items()})
    return np.asarray(res.stored_array("out", len(data["keys"])))


@pytest.mark.parametrize("w", [16, 32, 2048, 4096])
def test_bptree_chase_compiles_to_the_reference_simulator(w):
    """A B+-tree of 64- and 128-byte nodes over 2^14 values, and of 8 KB
    and 16 KB nodes (PostgreSQL's and InnoDB's pages) over 2^15: JAX's
    check accepts its ChaseSpec; the port compiles the same program (on
    the CPU, the kernel's plain version) to the JAX simulator's stores
    bit for bit, and those are torch.searchsorted(right=True).  The plan
    is the path's own: rif 1 on the shared-memory path, STREAM_DEPTH
    windows on the streamed path."""
    data = bptree_data(w, 1 << (14 if w < 1024 else 15), 300, seed=w)
    want = _reference_stores(data)
    jprog, jmems, jspec = bptree_program(data, dae=jdae, wl=jwl, ir=jir)
    jchk = jc.check(jprog, jc.elaborate(jprog, jmems), chase=jspec)
    assert jchk.shape == "chase"
    tprog, tmems, tspec = bptree_program(data, dae=tdae, wl=twl, ir=tir)
    ck = tc.compile_program(tprog, tmems, chase=tspec, device="cpu")
    assert (ck.shape, ck.out_specs) == (jchk.shape, jchk.out_specs)
    got = ck()["out"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.searchsorted(data["table"], data["keys"], side="right"))
    (plan,) = ck.plans.values()
    path = rk.chase_path(4, w)
    want_rif = 1 if path == "smem" else rk.STREAM_DEPTH
    assert path == ("smem" if w < rk.STREAM_ROW else "stream")
    assert plan.rif == want_rif and \
        f"planned down to {want_rif}" in plan.note
    assert rk.chase_rif_cap(4, w) >= plan.rif >= 1


def test_batched_plain_chase_equals_unbatched():
    """``ring_chase_plain`` takes items in batches of bounded bytes; a
    batch of 7 items gives the unbatched result and the same row
    numbers each level."""
    data = bptree_data(2048, 1 << 15, 300, seed=9)
    port = torch.from_numpy(data["rows"])
    state0 = torch.from_numpy(bptree_state0(data["keys"]).reshape(-1))
    prog = cops.trace_chase(*bptree_fns(data["offs"], 2048), 4, 2048)
    kw = dict(max_steps=len(data["offs"]), s_width=4)
    one, many = [[] for _ in data["offs"]], [[] for _ in data["offs"]]
    want = rk.ring_chase_plain(port, state0, prog, levels=one, **kw)
    got = rk.ring_chase_plain(port, state0, prog, batch_bytes=7 * 2048 * 4,
                              levels=many, **kw)
    assert all(len(x) == 1 for x in one) and all(len(x) == 43 for x in many)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    for a, b in zip(one, many):
        assert torch.equal(a[0], torch.cat(b))
    np.testing.assert_array_equal(
        got[1].numpy(), np.searchsorted(data["table"], data["keys"],
                                        side="right"))


def test_int16_port_chase_matches_the_reference_simulator():
    """A port of int16 nodes (padded with int16's largest) runs through a
    compiled chase as int32 words and equals JAX's simulator."""
    data = bptree_data(16, 1 << 11, 200, seed=5, dtype=np.int16)
    assert data["rows"].dtype == np.int16
    tprog, tmems, tspec = bptree_program(data, dae=tdae, wl=twl, ir=tir)
    ck = tc.compile_program(tprog, tmems, chase=tspec, device="cpu")
    np.testing.assert_array_equal(ck()["out"], _reference_stores(data))


def test_chase_port_outside_int32_raises():
    """An int64 port holding a value past int32 (a node no key reaches)
    raises in codegen, naming the port, rather than wrap it into the
    kernel's words."""
    data = bptree_data(16, 1 << 10, 40, seed=6)
    data["rows"] = np.concatenate(
        [data["rows"].astype(np.int64), np.full((1, 16), 1 << 33)])
    tprog, tmems, tspec = bptree_program(data, dae=tdae, wl=twl, ir=tir)
    with pytest.raises(tc.CompileError, match="'tree' holds 8589934592"):
        tc.compile_program(tprog, tmems, chase=tspec, device="cpu")


def test_chase_rif_clamped_to_the_shared_memory_path():
    """512-byte nodes, the widest the shared-memory path still plans: an
    explicit rif 16 is clamped to the 13 x 32 rows of a warp that 227 KB
    hold, with a note; 4 KB nodes take the streamed path, where rif 8 is
    clamped to the STREAM_DEPTH windows in flight its library holds.
    Both programs still equal the reference simulator."""
    for w, rif, want, where in ((128, 16, 13, "shared-memory path"),
                                (1024, 8, rk.STREAM_DEPTH,
                                 "streamed path")):
        data = bptree_data(w, 1 << 15, 40, seed=7)
        tprog, tmems, tspec = bptree_program(data, dae=tdae, wl=twl, ir=tir,
                                             rif=rif)     # capacity rif + 1
        ck = tc.compile_program(tprog, tmems, chase=tspec, rif=rif,
                                chunk=64, device="cpu")
        (plan,) = ck.plans.values()
        assert plan.rif == want and where in plan.note
        assert f"rif={want}" in ck.describe()
        np.testing.assert_array_equal(ck()["out"], _reference_stores(data))


@pytest.mark.parametrize("s,w,rif,nbytes", [
    (4, 16, 1, 2688), (4, 16, 16, 43008), (12, 5, 6, 14592),
    (9, 9, 8, 19456), (2, 1024, 1, 131712), (2, 1024, 2, 263424)])
def test_chase_shared_memory_layout(s, w, rif, nbytes):
    """One warp's region: 32 x rif rows at an odd pitch (4-byte copies)
    or a pitch of an odd number of 16-byte units, their addresses, and
    the states at an odd pitch once rif states pass 64 words; where the
    shared-memory path is planned, the rif cap is the largest region
    within 227 KB; rows of STREAM_ROW words and more, and rows no warp
    region holds (8 KB), take the streamed path and its cap of
    STREAM_DEPTH windows, the one depth its library holds, never 0."""
    assert rk.chase_warp_bytes(s, w, rif) == nbytes
    cap = rk.chase_rif_cap(s, w)
    if rk.chase_path(s, w) == "smem":
        assert rk.chase_warp_bytes(s, w, cap) <= 232_448
        assert cap == MAX_RIF or \
            rk.chase_warp_bytes(s, w, cap + 1) > 232_448
    else:
        assert w >= rk.STREAM_ROW and cap == rk.STREAM_DEPTH
    assert rk.chase_rif_cap(8, 8) == MAX_RIF
    assert rk.chase_rif_cap(2, 2048) == rk.STREAM_DEPTH


@pytest.mark.parametrize("s,w,rif,cta,warps", [
    (4, 16, 1, 4, 64), (4, 16, 9, 4, 8), (4, 32, 1, 4, 44),
    (4, 32, 13, 3, 3), (4, 128, 7, 1, 1), (2, 1024, 1, 1, 1),
    (12, 5, 6, 4, 12)])
def test_chase_smem_warps_fill_an_sm(s, w, rif, cta, warps):
    """The shared-memory path's occupancy as shared memory sets it: a CTA
    of up to 4 warps whose regions fit the 227 KB opt-in, and as many
    CTAs as an SM's 228 KB hold beside 1 KB each, at most 64 warps."""
    assert rk.chase_smem_warps(s, w, rif) == (cta, warps)
    per_cta = cta * rk.chase_warp_bytes(s, w, rif) + rk.CTA_RESERVED_BYTES
    ctas = warps // cta
    assert ctas * per_cta <= rk.SM_SMEM_BYTES
    assert warps == rk.SM_MAX_WARPS or (ctas + 1) * per_cta > rk.SM_SMEM_BYTES
    assert rk.chase_smem_warps(2, 2048, 1) == (0, 0)


@pytest.mark.parametrize("s,w,rif,want", [
    (1, 1, 9, 9), (8, 8, 16, 16), (4, 9, 9, 1), (9, 1, 6, 1),
    (4, 16, 9, 1), (3, 256, 4, 1), (4, 16, 1, 1)])
def test_chase_plan_rif_by_path(s, w, rif, want):
    """The planned depth: the register path's own, 1 on the
    shared-memory path (warps, not items a thread, hide its loads)."""
    assert rk.chase_plan_rif(s, w, rif) == want


def test_explicit_chase_rif_is_kept_where_it_fits():
    """A caller's rif on the shared-memory path is not planned down: rif
    4 at 16-word nodes fits 227 KB and launches as asked."""
    data = bptree_data(16, 1 << 12, 60, seed=8)
    tprog, tmems, tspec = bptree_program(data, dae=tdae, wl=twl, ir=tir)
    ck = tc.compile_program(tprog, tmems, chase=tspec, rif=4, chunk=64,
                            device="cpu")
    (plan,) = ck.plans.values()
    assert plan.rif == 4 and plan.note == ""
    np.testing.assert_array_equal(ck()["out"], _reference_stores(data))
