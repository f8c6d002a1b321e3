"""The chase kernel's generated C++ on the CPU.

``repro_torch.compile.chase.emit_program`` writes a traced ChaseSpec as
three straight-line C++ functions that ``csrc/ring_chase.cuh``'s CUDA
kernel is instantiated on.  Those functions and the arithmetic helpers
of the header compile for the host too, so this file builds them with
``g++`` into a harness of its own, which walks every item through
Listing 5's lock-step levels as the kernel does (address, clipped row
load, step; then the output function).  Even items step as the register
path does (state and row in arrays, the new state into another), odd
items as the shared-memory path does (the row read through a pointer
into the port, the state stepped in place).  Each result is held to
``run_numpy``, the numpy model of the kernel's int32 semantics, bit for
bit: the binsearch and binsearch_for specs of the compile targets, the
specs of the card-only tests (states of 9 and 12 words, rows of 9, 17
and 256 words, the B+-tree searches of 16- and 32-word nodes), 40
seeded random chase programs over every operator the tracer knows, and
the wrap and floor edges (``INT_MIN // -1``, ``x // 0``, ``x % 0``,
negative operands, constant and computed divisors).  The harness also
prints the header's shared-memory layout, held to the wrapper's.  The
random programs are drawn here: the 40 seeded DAE programs of
``test_torch_compile.py`` carry no ChaseSpec, so none of them reaches
the chase.  Skips only where ``g++`` is absent.
"""

import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

import repro_torch.compile.targets as tt
from repro_torch.compile import chase as cops
from repro_torch.kernels.compiled import kernel as rk
from repro_torch.bench.chases import (bptree, bptree_fns, bptree_state0,
                                      mix_fns)
from test_torch_gpu import _floor_spec, _wide_spec

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1

HARNESS = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "ring_chase.cuh"

%(programs)s

template <class P>
int walk(const char* port_path, long long n, const char* state_path,
         long long m, int steps, const char* out_path) {
  constexpr int S = P::S, W = P::W;
  std::vector<int32_t> port(n * W), state(m * S), out(2 * m);
  FILE* f = std::fopen(port_path, "rb");
  if (std::fread(port.data(), 4, n * W, f) != (size_t)(n * W)) return 2;
  std::fclose(f);
  f = std::fopen(state_path, "rb");
  if (std::fread(state.data(), 4, m * S, f) != (size_t)(m * S)) return 2;
  std::fclose(f);
  for (long long i = 0; i < m; ++i) {
    int32_t st[S], row[W], next[S];
    for (int q = 0; q < S; ++q) st[q] = state[i * S + q];
    for (int level = 0; level < steps; ++level) {
      long long a = P::addr(st);
      a = a < 0 ? 0 : (a >= n ? n - 1 : a);
      if (i %% 2 == 0) {
        for (int q = 0; q < W; ++q) row[q] = port[a * W + q];
        P::step(st, row, next);
        for (int q = 0; q < S; ++q) st[q] = next[q];
      } else {
        int32_t* s = st;
        const int32_t* r = &port[a * W];
        P::step(s, r, s);
      }
    }
    P::out(st, out[i], out[m + i]);
  }
  f = std::fopen(out_path, "wb");
  std::fwrite(out.data(), 4, 2 * m, f);
  std::fclose(f);
  return 0;
}

int main(int argc, char** argv) {
  const int which = std::atoi(argv[1]);
  if (which < 0) {                     // the layout: S W R
    const int s = std::atoi(argv[2]), w = std::atoi(argv[3]);
    const int r = std::atoi(argv[4]);
    std::printf("%%d %%d %%lld\n", (int)chase::register_path(s, w),
                chase::row_pitch(w), chase::warp_smem_bytes(s, w, r));
    return 0;
  }
  const long long n = std::atoll(argv[3]), m = std::atoll(argv[5]);
  const int steps = std::atoi(argv[6]);
  switch (which) {
%(cases)s
  }
  return 3;
}
"""


# -- the programs ------------------------------------------------------------


def _target_spec(name):
    spec = tt.build_target(name).chase
    return spec.addr_fn, spec.step_fn, spec.out_fn, spec.state_width, 1


_CONSTS = (0, 1, -1, 2, 3, -3, 4, 7, 8, -8, 16, 1000, INT_MIN, INT_MAX)
_BINARY = ("+", "-", "*", "//", "%", "<", "<=", ">", ">=", "==", "!=", "&",
           "|", "^", "where", "min", "max")


def _random_tree(rng, depth, n_leaves):
    """A random expression: ("leaf", i) reads input i, ("const", v) a
    constant, else (op, children...)."""
    if depth == 0 or rng.random() < 0.25:
        if rng.random() < 0.3:
            return ("const", rng.choice(_CONSTS + (rng.randint(-99, 99),)))
        return ("leaf", rng.randrange(n_leaves))
    kind = rng.random()
    if kind < 0.15:
        return (rng.choice(("~", "neg", "~cmp")),
                _random_tree(rng, depth - 1, n_leaves))
    if kind < 0.22:
        return ("clip", *(_random_tree(rng, depth - 1, n_leaves)
                          for _ in range(3)))
    op = rng.choice(_BINARY)
    arity = 3 if op == "where" else 2
    return (op, *(_random_tree(rng, depth - 1, n_leaves)
                  for _ in range(arity)))


def _evaluate(node, leaves):
    """``node`` over traced inputs, through the tracer's operators and
    chase.where/minimum/maximum/clip; constants are traced too, so no
    operation runs on Python ints."""
    op, *args = node
    if op == "leaf":
        return leaves[args[0]]
    if op == "const":
        return leaves[0].trace.const(args[0])
    v = [_evaluate(a, leaves) for a in args]
    if op == "~":
        return ~v[0]
    if op == "neg":
        return -v[0]
    if op == "~cmp":
        return ~(v[0] < 0)
    if op == "clip":
        return cops.clip(*v)
    if op == "where":
        return cops.where(v[0], v[1], v[2])
    if op == "min":
        return cops.minimum(v[0], v[1])
    if op == "max":
        return cops.maximum(v[0], v[1])
    x, y = v
    return {"+": lambda: x + y, "-": lambda: x - y, "*": lambda: x * y,
            "//": lambda: x // y, "%": lambda: x % y, "<": lambda: x < y,
            "<=": lambda: x <= y, ">": lambda: x > y, ">=": lambda: x >= y,
            "==": lambda: x == y, "!=": lambda: x != y, "&": lambda: x & y,
            "|": lambda: x | y, "^": lambda: x ^ y}[op]()


def _random_spec(seed):
    rng = random.Random(seed)
    s, w = rng.randint(1, 8), rng.randint(1, 8)
    addr = _random_tree(rng, 3, s)
    steps = [_random_tree(rng, 3, s + w) for _ in range(s)]
    outs = [_random_tree(rng, 2, s) for _ in range(2)]

    def addr_fn(st):
        return _evaluate(addr, st)

    def step_fn(st, row):
        return tuple(_evaluate(t, tuple(st) + tuple(row)) for t in steps)

    def out_fn(st):
        return tuple(_evaluate(t, st) for t in outs)

    return addr_fn, step_fn, out_fn, s, w


def _edge_specs():
    """Floor and wrap edges: computed and constant divisors of every
    sign, zero, -1 and INT_MIN, each pair of the final state an output."""
    def addr_fn(st):
        return st[0]

    def step_fn(st, row):
        a, b = st[0], st[1]
        return (a // b, a % b, a // -1, a // 0, a % 0, a // 4, a % 8,
                (a * b) // -3)

    def pair(i):
        return lambda st: (st[2 * i], st[2 * i + 1])

    return [(addr_fn, step_fn, pair(i), 8, 1) for i in range(4)]


def _bptree_case(w):
    """A sorted table of 2^12 and its B+-tree of w-word nodes: the spec's
    tree layout is a literal of the emitted functions."""
    table = np.cumsum(np.random.default_rng(w).integers(1, 16, 1 << 12)
                      ).astype(np.int32)
    rows, offs = bptree(table, w)
    return table, rows, offs


BPTREE = {w: _bptree_case(w) for w in (16, 32)}
MIXED = {"s9": (9, 3), "s12": (12, 5), "w9": (4, 9), "w17": (3, 17),
         "w256": (3, 256)}

PROGRAMS = {
    "binsearch": _target_spec("binsearch"),
    "binsearch_for": _target_spec("binsearch_for"),
    "wide": (*_wide_spec(), 8, 8),
    "floor": (*_floor_spec(), 2, 1),
    **{name: (*mix_fns(s, w), s, w) for name, (s, w) in MIXED.items()},
    **{f"bptree{w}": (*bptree_fns(BPTREE[w][2], w), 4, w) for w in BPTREE},
    **{f"edges{i}": spec for i, spec in enumerate(_edge_specs())},
    **{f"random{seed}": _random_spec(seed) for seed in range(40)},
}
NAMES = sorted(PROGRAMS)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """One g++ build of every program's emitted functions."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    traced = {name: cops.trace_chase(*PROGRAMS[name]) for name in NAMES}
    programs = "\n".join(
        f"namespace p{i} {{\n{cops.emit_program(traced[n].words)}}}"
        for i, n in enumerate(NAMES))
    cases = "\n".join(
        f"    case {i}: return walk<p{i}::Program>(argv[2], n, argv[4], m, "
        f"steps, argv[7]);" for i in range(len(NAMES)))
    d = tmp_path_factory.mktemp("chase_cpp")
    src = d / "harness.cpp"
    src.write_text(HARNESS % {"programs": programs, "cases": cases})
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O1", f"-I{CSRC}", "-o", str(exe),
                    str(src)], check=True, capture_output=True, text=True)
    return exe, traced, d


def _run(harness, name, port, state0, steps):
    exe, traced, d = harness
    m = state0.shape[0]
    (d / f"{name}.port").write_bytes(np.ascontiguousarray(port).tobytes())
    (d / f"{name}.state").write_bytes(np.ascontiguousarray(state0).tobytes())
    out = d / f"{name}.out"
    subprocess.run([str(exe), str(NAMES.index(name)), str(d / f"{name}.port"),
                    str(port.shape[0]), str(d / f"{name}.state"), str(m),
                    str(steps), str(out)], check=True)
    got = np.frombuffer(out.read_bytes(), np.int32).reshape(2, m)
    return got, traced[name]


def _check(harness, name, port, state0, steps):
    got, prog = _run(harness, name, port, state0, steps)
    want = cops.run_numpy(prog, port, state0, steps)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _random_state(rng, m, s):
    """Uniform int32 with the edge values mixed in."""
    state = rng.integers(INT_MIN, INT_MAX, (m, s), dtype=np.int64)
    edges = np.array([0, 1, -1, 2, -2, 7, -7, INT_MIN, INT_MAX])
    mask = rng.random((m, s)) < 0.3
    state[mask] = rng.choice(edges, int(mask.sum()))
    return state.astype(np.int32)


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n.startswith("random")])
def test_random_programs_match_run_numpy(harness, name):
    seed = int(name[len("random"):])
    s, w = PROGRAMS[name][3:]
    rng = np.random.default_rng(seed)
    port = _random_state(rng, 257, w)
    _check(harness, name, port, _random_state(rng, 300, s), 4)


@pytest.mark.parametrize("name", ["wide", "floor"])
def test_card_test_specs_match_run_numpy(harness, name):
    s, w = PROGRAMS[name][3:]
    rng = np.random.default_rng(len(name))
    port = rng.integers(-1000, 1000, (1 << 12, w)).astype(np.int32)
    _check(harness, name, port, _random_state(rng, 500, s), 5)


@pytest.mark.parametrize("name", sorted(MIXED))
def test_wide_specs_match_run_numpy(harness, name):
    """States past 8 words and rows past 8, 16 and 256 words (the last a
    program of more than 512 instructions)."""
    s, w = MIXED[name]
    rng = np.random.default_rng(s * w)
    port = _random_state(rng, 999, w)
    _check(harness, name, port, _random_state(rng, 301, s), 4)
    if name == "w256":
        assert harness[1][name].n_instr > 512


@pytest.mark.parametrize("w", sorted(BPTREE))
def test_bptree_specs_match_run_numpy(harness, w):
    """The B+-tree searches over their own trees, members and misses
    mixed; the answers are searchsorted(right) as well."""
    table, rows, offs = BPTREE[w]
    rng = np.random.default_rng(w + 1)
    keys = np.concatenate([table[rng.integers(0, len(table), 150)],
                           rng.integers(-5, int(table[-1]) + 16, 150)])
    state0 = bptree_state0(keys)
    _check(harness, f"bptree{w}", rows, state0, len(offs))
    got, _ = _run(harness, f"bptree{w}", rows, state0, len(offs))
    np.testing.assert_array_equal(got[1], np.searchsorted(table, keys,
                                                          side="right"))


@pytest.mark.parametrize("s,w", [(1, 1), (8, 8), (9, 1), (4, 9), (4, 16),
                                 (3, 17), (9, 32), (12, 5), (2, 1024),
                                 (64, 1024), (3, 10)])
def test_shared_memory_layout_matches_the_wrapper(harness, s, w):
    """``ring_chase.cuh``'s path choice, row pitch and warp region, as
    the compiler computes them, equal the wrapper's mirror at every rif."""
    exe = harness[0]
    for r in range(1, 17):
        out = subprocess.run([str(exe), "-1", str(s), str(w), str(r)],
                             check=True, capture_output=True, text=True)
        reg, pitch, nbytes = (int(x) for x in out.stdout.split())
        assert bool(reg) == rk.chase_register_path(s, w)
        assert nbytes == rk.chase_warp_bytes(s, w, r)
        assert pitch >= w and (pitch % 2 == 1 or (pitch // 4) % 2 == 1)


@pytest.mark.parametrize("name", ["binsearch", "binsearch_for"])
def test_binsearch_specs_match_run_numpy(harness, name):
    """The targets' specs over a sorted table of their own width n: the
    emitted functions carry n as a literal."""
    spec = tt.build_target(name).chase
    n = int(spec.state0[0, 3])
    rng = np.random.default_rng(n)
    table = np.sort(rng.integers(0, 4 * n, n)).astype(np.int32)
    state0 = spec.state0.astype(np.int32).copy()
    keys = rng.integers(-5, 4 * n + 5, state0.shape[0]).astype(np.int32)
    keys[: min(4, len(keys))] = table[: min(4, len(keys))]   # members
    state0[:, 1] = keys
    _check(harness, name, table.reshape(n, 1), state0, spec.max_steps)


@pytest.mark.parametrize("i", range(4))
def test_floor_and_wrap_edges_match_run_numpy(harness, i):
    a = np.array([INT_MIN, INT_MIN, -7, -7, 7, 7, 0, -1, INT_MAX, 5, -9, 12],
                 np.int64)
    b = np.array([-1, 1, 2, -2, -2, 0, 3, INT_MIN, -1, 0, 4, -5], np.int64)
    state0 = np.zeros((len(a), 8), np.int32)
    state0[:, 0], state0[:, 1] = a, b
    port = np.zeros((1, 1), np.int32)
    _check(harness, f"edges{i}", port, state0, 1)


def test_constant_divisors_are_folded():
    """``// 2`` and ``% 8`` by constants become a shift and a mask; ``//``
    and ``%`` by 0 become 0; ``// -1`` a wrapping negation; only a
    computed or non-power-of-two divisor calls chase::fdiv/fmod."""
    prog = cops.trace_chase(lambda s: s[0] // 2,
                            lambda s, r: (s[0] % 8, s[1] // 0, s[1] % 0,
                                          s[0] // -1, s[0] // 3, s[0] // s[1]),
                            lambda s: (s[0], s[1]), 6, 1)
    src = cops.emit_program(prog.words)
    assert ">> 1" in src and "& 7" in src and "chase::neg(" in src
    assert src.count("chase::fdiv(") == 2 and "chase::fmod(" not in src
