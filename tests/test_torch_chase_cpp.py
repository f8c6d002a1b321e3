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
into the port, the state stepped in place), and, in a program wider
than the register path, every third item as the streamed path does:
``stream_step`` in place, its row words read a 16-byte unit at a time
from a copy of the one window of ``WINDOW_WORDS`` words that its last
``window<I>`` hook named (a read outside it aborts, as do hooks out of
order).  Each result is held to
``run_numpy``, the numpy model of the kernel's int32 semantics, bit for
bit: the binsearch and binsearch_for specs of the compile targets, the
specs of the card-only tests (states of 9, 12 and 70 words, rows of 9,
17, 256 and 601 words, the B+-tree searches of 16-, 32-, 2048- and
4096-word nodes), 40
seeded random chase programs over every operator the tracer knows, and
the wrap and floor edges (``INT_MIN // -1``, ``x // 0``, ``x % 0``,
negative operands, constant and computed divisors).  The harness also
prints the header's shared-memory and streamed layouts, its choice of
path and the streamed depths a library holds, held to the wrapper's.
The harness builds at ``-O1``; the 2048- and 4096-word searches (some
4,000 and 8,000 lines a function) go in a second binary at ``-O0``,
built with ``REPRO_CHASE_SWEEP`` as ``tools/ring_sweep.py``'s library
is, whose layout answers are held to the wrapper's sweep build.  The
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

// The streamed path's row on the host: window<I> copies window
// P::kWindows[I] of the item's row (words past W are garbage, as in the
// kernel's last window), unit<U> must lie in the current window, and
// the hooks must come in order, P::kNumWindows of them a step.
template <class P>
struct HostRow {
  const int32_t* row;
  int32_t buf[chase::kWindowWords];
  int current = -1, hooks = 0;
  template <int I>
  void window() {
    if (I != hooks++) std::abort();
    current = P::kWindows[I];
    for (int q = 0; q < chase::kWindowWords; ++q) {
      const int word = current * chase::kWindowWords + q;
      buf[q] = word < P::W ? row[word] : 0x5a5a5a5a;
    }
  }
  template <int U>
  chase::Unit unit() const {
    const int o = 4 * U - current * chase::kWindowWords;
    if (o < 0 || o >= chase::kWindowWords) std::abort();
    return chase::Unit{buf[o], buf[o + 1], buf[o + 2], buf[o + 3]};
  }
};

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
      if constexpr (!chase::register_path(S, W)) {
        if (i %% 3 == 2) {             // the streamed path's step, in place
          HostRow<P> r{&port[a * W]};
          P::stream_step(st, r, st);
          if (r.hooks != P::kNumWindows) std::abort();
          continue;
        }
      }
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
    std::printf("%%d %%d %%lld %%d %%d %%lld %%d %%d\n",
                (int)chase::register_path(s, w), chase::row_pitch(w),
                chase::warp_smem_bytes(s, w, r),
                (int)chase::stream_built(s, w), chase::planned_path(s, w),
                chase::stream_warp_bytes(r),
                (int)chase::stream_state_in_registers(s),
                (int)chase::stream_depth_built(r));
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


def _bptree_case(w, n=1 << 12):
    """A sorted table of n and its B+-tree of w-word nodes: the spec's
    tree layout is a literal of the emitted functions."""
    table = np.cumsum(np.random.default_rng(w).integers(1, 16, n)
                      ).astype(np.int32)
    rows, offs = bptree(table, w)
    return table, rows, offs


BPTREE = {w: _bptree_case(w) for w in (16, 32)}
# the B+-trees of 8 KB and 16 KB nodes over 2^15 values (two levels)
BPTREE.update({w: _bptree_case(w, 1 << 15) for w in (2048, 4096)})
MIXED = {"s9": (9, 3), "s12": (12, 5), "w9": (4, 9), "w17": (3, 17),
         "w256": (3, 256), "s70w601": (70, 601)}

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
# the programs of the second binary, at -O0 and in the sweep's build
WIDE = ("bptree2048", "bptree4096")


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """Two g++ builds of the programs' emitted functions, at once: every
    program but ``WIDE`` at ``-O1``, and ``WIDE`` at ``-O0`` with
    ``REPRO_CHASE_SWEEP``.  Returns ({"": the first, "sweep": the
    second}, the traced programs, the directory)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    traced = {name: cops.trace_chase(*PROGRAMS[name]) for name in NAMES}
    d = tmp_path_factory.mktemp("chase_cpp")
    exes, builds = {}, []
    for key, names, flags in (
            ("", [n for n in NAMES if n not in WIDE], ["-O1"]),
            ("sweep", list(WIDE), ["-O0", "-DREPRO_CHASE_SWEEP"])):
        programs = "\n".join(
            f"namespace p{NAMES.index(n)} {{\n"
            f"{cops.emit_program(traced[n].words)}}}" for n in names)
        cases = "\n".join(
            f"    case {NAMES.index(n)}: return walk<p{NAMES.index(n)}::"
            f"Program>(argv[2], n, argv[4], m, steps, argv[7]);"
            for n in names)
        src = d / f"harness{key}.cpp"
        src.write_text(HARNESS % {"programs": programs, "cases": cases})
        exes[key] = d / f"harness{key}"
        builds.append(subprocess.Popen(
            [gxx, "-std=c++17", *flags, f"-I{CSRC}", "-o", str(exes[key]),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for b in builds:
        out, _ = b.communicate()
        assert b.returncode == 0, out
    return exes, traced, d


def _layout(harness, s, w, r, sweep=False):
    """The header's layout answers for (S, W, rif), as integers."""
    out = subprocess.run([str(harness[0]["sweep" if sweep else ""]), "-1",
                          str(s), str(w), str(r)],
                         check=True, capture_output=True, text=True)
    return [int(x) for x in out.stdout.split()]


def _run(harness, name, port, state0, steps):
    exes, traced, d = harness
    exe = exes["sweep" if name in WIDE else ""]
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
    program of more than 512 instructions); a state of 70 words on rows
    of 601, whose last 16-byte unit holds one word."""
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
    for r in range(1, 17):
        reg, pitch, nbytes = _layout(harness, s, w, r)[:3]
        assert bool(reg) == rk.chase_register_path(s, w)
        assert nbytes == rk.chase_warp_bytes(s, w, r)
        assert pitch >= w and (pitch % 2 == 1 or (pitch // 4) % 2 == 1)


@pytest.mark.parametrize("s,w", [(8, 8), (4, 16), (3, 256), (4, 511),
                                 (4, 512), (2, 1024), (4, 1023), (4, 1792),
                                 (4, 2048), (4, 4096), (64, 2049),
                                 (65, 2049), (2000, 16), (80, 16)])
def test_streamed_layout_matches_the_wrapper(harness, s, w):
    """The streamed path as ``ring_chase.cuh`` computes it: whether a
    program's library holds it, the path a launch plans, one warp's
    region at each depth, whether the state stays in registers, which
    depths a library holds (``STREAM_DEPTH`` alone; 1 to
    ``STREAM_MAX_DEPTH`` and every width past the register path in the
    sweep's build); each equals the wrapper's mirror, and the region's
    buffers hold windows of ``WINDOW_WORDS`` words at a pitch of an odd
    number of 16-byte units."""
    assert rk.STREAM_PITCH % 4 == 0 and (rk.STREAM_PITCH // 4) % 2 == 1
    assert rk.STREAM_PITCH >= rk.WINDOW_WORDS
    for r in range(1, rk.STREAM_MAX_DEPTH + 2):
        for sweep in (False, True):
            (_reg, _pitch, _nbytes, built, path, nbytes, regs,
             depth) = _layout(harness, s, w, r, sweep)
            assert bool(built) == rk.chase_stream_built(s, w, sweep)
            assert path == rk.CHASE_PATHS[rk.chase_path(s, w)]
            assert nbytes == rk.chase_stream_bytes(r)
            assert bool(regs) == (s <= rk.REG_STATE_WORDS)
            assert bool(depth) == (r <= rk.STREAM_MAX_DEPTH if sweep
                                   else r == rk.STREAM_DEPTH)
            # the planned path is always one the library holds
            assert rk.chase_path(s, w) != "stream" or built
    assert rk.chase_rif_cap(s, w) >= 1
    assert 1 <= rk.chase_plan_rif(s, w, 8) <= rk.chase_rif_cap(s, w)
    if rk.chase_path(s, w) == "stream":
        assert rk.chase_plan_rif(s, w, 8) == rk.STREAM_DEPTH


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
