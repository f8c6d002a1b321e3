"""The paper's seven benchmarks as explicit-decoupling DAE programs (§4, §6).

The port's copy of ``repro.core.workloads``, unchanged but
for imports: host code, held bit for bit to the reference by
``tests/test_torch_dae_model.py``.

Each benchmark is expressed in the paper's five configurations:

  * ``vitis``       — statically scheduled baseline: dependent loads block
                      for the full memory latency plus a schedule overhead
                      (``VITIS_OVH``); FP accumulation loops carry an
                      II=8 initiation-interval floor (Vivado FP-add chain).
  * ``vitis_dec``   — explicit decoupling via repurposed burst interfaces
                      (§5.2): decoupled request/execute loops, but the
                      static schedule holds the execute loop at II=3 and
                      only ONE request/response pair may be outstanding
                      per pointer argument for data-dependent consumption
                      order (the Mergesort limitation).
  * ``rhls``        — dynamic HLS without decoupling: dataflow operators
                      pipeline independent loads at II=1, but request
                      generation stays gated by program dependencies
                      (e.g. SPMV's ``rows`` loads), and stores gate the
                      state edge (§5.4).
  * ``rhls_stream`` — loads + streams approximating decoupling (§3.2);
                      same steady-state throughput as decoupling but
                      with an extra stream hop, and a structural deadlock
                      for mergesort (two fetch loops share the
                      disambiguation queue — reproduced here).
  * ``rhls_dec``    — full explicit decoupling in dynamic HLS (§5.3).

Cycle-model calibration constants are module-level and documented; the
goal is to reproduce the paper's Table 1 speedup bands and the Fig. 4
golden-overhead structure, not RTL-exact cycle counts (see
EXPERIMENTS.md §Repro for the side-by-side comparison).

Every program also *computes the real result* through the simulated
memory system; results are checked against a NumPy reference, and the
simulator enforces the paper's §5.1 conservation rules.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dae import (
    DaeProgram,
    Delay,
    Deq,
    Enq,
    LoadChannel,
    Process,
    Req,
    Resp,
    Store,
    StoreWait,
    StreamChannel,
)
from repro_torch.core.simulator import (
    DeadlockError,
    EngineInstance,
    FixedLatencyMemory,
    Fused,
    MemoryModel,
    MomsMemory,
    Par,
    SharedMemoryEngine,
    SimResult,
    simulate,
)
from repro_torch.core.trace import Tracer, TraceSummary

__all__ = ["BENCHMARKS", "CONFIGS", "MULTI_BENCHMARKS", "run_workload",
           "run_workload_multi", "WorkloadReport", "MultiWorkloadReport",
           "make_gather_data", "gather_ref", "gather_phases",
           "make_frontier_data", "frontier_ref", "frontier_phases",
           "make_gmm_data", "gmm_ref", "gmm_phases",
           "spmv_gather_ref", "spmv_gather_phases"]

CONFIGS = ("vitis", "vitis_dec", "rhls", "rhls_stream", "rhls_dec")
BENCHMARKS = (
    "binsearch",
    "binsearch_for",
    "hashtable",
    "mergesort",
    "mergesort_opt",
    "spmv",
    "multispmv",
)

# --- calibration constants (documented in EXPERIMENTS.md §Repro) -----------
VITIS_OVH = 10       # static-schedule overhead per dependent-load iteration
VITIS_DEC_II = 3     # Vitis Decoupled execute-loop initiation interval
VITIS_FP_II = 8      # Vivado FP accumulate loop-carried II
VITIS_ROW_FILL = 30  # static pipeline fill/drain per outer-loop iteration
RHLS_STORE_GATE = 50 # R-HLS (non-decoupled) store state-edge release delay


# ---------------------------------------------------------------------------
# Dataset construction
# ---------------------------------------------------------------------------


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def make_binsearch_data(scale: str, seed: int = 0) -> Dict[str, Any]:
    n, lookups = {
        "paper": (1_234_567, 1_000),
        "fig4": (1_234_567, 4_000),
        "small": (1_021, 24),
    }[scale]
    r = _rng(seed)
    arr = np.unique(r.integers(0, n * 8, size=n * 2))[:n].astype(np.int64)
    assert len(arr) == n
    keys = arr[r.integers(0, n, size=lookups)]
    return {"arr": arr, "keys": keys, "n": n}


def make_hashtable_data(scale: str, seed: int = 1) -> Dict[str, Any]:
    chains, chain_len = {
        "paper": (1_024, 16),
        "fig4": (4_096, 16),
        "small": (16, 4),
    }[scale]
    n_entries = chains * chain_len
    # entry = (key, value, next_idx); chain c occupies [c*L, (c+1)*L)
    entries: List[Tuple[int, int, int]] = []
    r = _rng(seed)
    values = r.integers(0, 1 << 30, size=n_entries)
    for c in range(chains):
        for k in range(chain_len):
            idx = c * chain_len + k
            nxt = idx + 1 if k + 1 < chain_len else -1
            entries.append((idx, int(values[idx]), nxt))
    # look up the LAST key of each chain -> walks the full chain
    lookup_keys = [c * chain_len + (chain_len - 1) for c in range(chains)]
    heads = [c * chain_len for c in range(chains)]
    return {
        "entries": entries,
        "keys": lookup_keys,
        "heads": heads,
        "chains": chains,
        "chain_len": chain_len,
    }


def make_spmv_data(scale: str, seed: int = 2) -> Dict[str, Any]:
    nrows, ncols, nnz = {
        "paper": (1_024, 16_777_216, 17_221),
        "fig4_sparse": (16_384, 16_777_216, 17_221),
        "fig4_dense": (128, 65_536, 65_536),
        "small": (16, 256, 64),
    }[scale]
    r = _rng(seed)
    counts = r.multinomial(nnz, np.ones(nrows) / nrows)
    rows = np.zeros(nrows + 1, dtype=np.int64)
    rows[1:] = np.cumsum(counts)
    cols = r.integers(0, ncols, size=nnz).astype(np.int64)
    val = r.standard_normal(nnz).astype(np.float64)
    vec = r.standard_normal(ncols).astype(np.float64)
    return {"rows": rows, "cols": cols, "val": val, "vec": vec, "nrows": nrows,
            "ncols": ncols, "nnz": nnz}


def make_mergesort_data(scale: str, seed: int = 3) -> Dict[str, Any]:
    n = {"paper": 234, "fig4": 8_192, "small": 37}[scale]
    r = _rng(seed)
    table = r.integers(0, 1 << 31, size=n).astype(np.int64)
    return {"table": table, "n": n}


def make_multispmv_data(scale: str, seed: int = 4) -> Dict[str, Any]:
    nrows, nnz, iters = {
        "paper": (128, 1_639, 10),
        "small": (8, 24, 3),
    }[scale]
    r = _rng(seed)
    counts = r.multinomial(nnz, np.ones(nrows) / nrows)
    rows = np.zeros(nrows + 1, dtype=np.int64)
    rows[1:] = np.cumsum(counts)
    cols = r.integers(0, nrows, size=nnz).astype(np.int64)
    val = (r.standard_normal(nnz) * 0.3).astype(np.float64)
    vec = r.standard_normal(nrows).astype(np.float64)
    return {"rows": rows, "cols": cols, "val": val, "vec": vec,
            "nrows": nrows, "nnz": nnz, "iters": iters, "alpha": 0.9}


# ---------------------------------------------------------------------------
# NumPy references + golden cycle models (paper Fig. 4)
# ---------------------------------------------------------------------------


def binsearch_ref(arr: np.ndarray, keys: np.ndarray, early: bool) -> Tuple[List[int], int]:
    """Returns (result index per key, total loads).  ``early`` is the
    early-exit variant; the _for variant runs EXACTLY ceil(log2 n)
    iterations (loads included — redundant once the range collapses, as
    the paper notes for the constant-iteration version)."""
    n = len(arr)
    iters_fixed = int(math.ceil(math.log2(n)))
    results, loads = [], 0
    for key in keys:
        lo, hi = 0, n
        if early:
            res = -1
            while lo < hi:
                mid = (lo + hi) // 2
                v = arr[mid]
                loads += 1
                if v == key:
                    res = mid
                    break
                if v <= key:
                    lo = mid + 1
                else:
                    hi = mid
            results.append(int(res))
        else:
            for _ in range(iters_fixed):
                mid = (lo + hi) // 2 if lo < hi else min(lo, n - 1)
                v = arr[mid]
                loads += 1
                if lo < hi:
                    if v <= key:
                        lo = mid + 1
                    else:
                        hi = mid
            results.append(int(lo))
    return results, loads


def hashtable_ref(entries: Sequence[Tuple[int, int, int]], keys: Sequence[int],
                  heads: Sequence[int]) -> Tuple[List[int], int]:
    results, loads = [], 0
    for key, head in zip(keys, heads):
        idx = head
        res = -1
        while idx >= 0:
            k, v, nxt = entries[idx]
            loads += 1
            if k == key:
                res = v
                break
            idx = nxt
        results.append(res)
    return results, loads


def spmv_ref(rows, cols, val, vec) -> np.ndarray:
    nrows = len(rows) - 1
    out = np.zeros(nrows, dtype=np.float64)
    for i in range(nrows):
        s = 0.0
        for j in range(rows[i], rows[i + 1]):
            s += val[j] * vec[cols[j]]
        out[i] = s
    return out


def multispmv_ref(rows, cols, val, vec, iters, alpha) -> np.ndarray:
    v = vec.copy()
    for _ in range(iters):
        out = spmv_ref(rows, cols, val, v)
        v = out * alpha
    return v


# ---------------------------------------------------------------------------
# Shared program fragments
# ---------------------------------------------------------------------------


def _blocking_load(ch: LoadChannel, addr: int, overhead: int = 0):
    """Coupled load: request + blocking response (+ schedule overhead)."""
    yield Req(ch, addr)
    v = yield Resp(ch)
    if overhead:
        yield Delay(overhead)
    return v


# -- parallel pointer chasing (paper Listings 4 & 5) ------------------------


def _roundrobin_chase(
    load_ch: LoadChannel,
    state_st: StreamChannel,
    n_items: int,
    init_state: Callable[[int], Tuple[Any, int]],
    step: Callable[[Any, Any], Tuple[bool, int, Any, Any, int]],
    out_port: str,
    rif: int,
):
    """Listing 4 (right): RIF pointer chains processed round-robin.

    ``init_state(i) -> (state, first_addr)``
    ``step(state, loaded) -> (done, out_idx, out_val, new_state, next_addr)``
    Every loop iteration is a single issue slot (II=1).
    """

    def gen():
        counters = {"started": 0, "inflight": 0, "finished": 0}

        def on_state_factory():
            def on_resp(v):
                def on_state(s):
                    done, oi, ov, ns, na = step(s, v)
                    if done:
                        counters["finished"] += 1
                        counters["inflight"] -= 1
                        return Store(out_port, oi, ov)
                    return Par([Req(load_ch, na), Enq(state_st, ns)])
                return Fused(Deq(state_st), on_state)
            return on_resp

        while counters["finished"] < n_items:
            if counters["inflight"] < rif and counters["started"] < n_items:
                s0, a0 = init_state(counters["started"])
                counters["started"] += 1
                counters["inflight"] += 1
                yield Par([Req(load_ch, a0), Enq(state_st, s0)])
            else:
                yield Fused(Resp(load_ch), on_state_factory())

    return gen


def _lockstep_chase(
    load_ch: LoadChannel,
    state_st: StreamChannel,
    n_items: int,
    iters: int,
    init_state: Callable[[int], Tuple[Any, int]],
    fixed_step: Callable[[Any, Any], Tuple[int, Any, Any, int]],
    out_port: str,
    chunk: int,
):
    """Listing 5: fixed-length chains, CHUNK-wide lock-step.

    ``fixed_step(state, loaded) -> (out_idx, out_val, new_state, next_addr)``
    — always produces a next address (redundant loads once resolved, as
    the paper notes), and out_val is stored only after the final
    iteration.
    """

    def gen():
        for c0 in range(0, n_items, chunk):
            c1 = min(c0 + chunk, n_items)
            # iteration 0: issue all requests for the chunk
            for i in range(c0, c1):
                s0, a0 = init_state(i)
                yield Par([Req(load_ch, a0), Enq(state_st, s0)])
            # iterations 1..iters-1: consume + re-request
            for j in range(1, iters):
                for _ in range(c0, c1):
                    def on_resp(v):
                        def on_state(s):
                            _, _, ns, na = fixed_step(s, v)
                            return Par([Req(load_ch, na), Enq(state_st, ns)])
                        return Fused(Deq(state_st), on_state)
                    yield Fused(Resp(load_ch), on_resp)
            # final consume round: store results
            for _ in range(c0, c1):
                def on_resp_last(v):
                    def on_state(s):
                        oi, ov, _, _ = fixed_step(s, v)
                        return Store(out_port, oi, ov)
                    return Fused(Deq(state_st), on_state)
                yield Fused(Resp(load_ch), on_resp_last)

    return gen


def _stream_chase(
    load_ch: LoadChannel,
    val_st: StreamChannel,
    state_st: StreamChannel,
    n_items: int,
    total_loads: int,
    init_state: Callable[[int], Tuple[Any, int]],
    step: Callable[[Any, Any], Tuple[bool, int, Any, Any, int]],
    out_port: str,
    rif: int,
):
    """R-HLS Stream: a separate Access unit forwards load responses into a
    value stream (paper §3.2 / Fig 2a); requires the exact load count up
    front — the streaming precision requirement the paper highlights."""

    def access_gen():
        for _ in range(total_loads):
            yield Fused(Resp(load_ch), lambda v: Enq(val_st, v))

    def exec_gen():
        counters = {"started": 0, "inflight": 0, "finished": 0}
        while counters["finished"] < n_items:
            if counters["inflight"] < rif and counters["started"] < n_items:
                s0, a0 = init_state(counters["started"])
                counters["started"] += 1
                counters["inflight"] += 1
                yield Par([Req(load_ch, a0), Enq(state_st, s0)])
            else:
                def on_v(v):
                    def on_state(s):
                        done, oi, ov, ns, na = step(s, v)
                        if done:
                            counters["finished"] += 1
                            counters["inflight"] -= 1
                            return Store(out_port, oi, ov)
                        return Par([Req(load_ch, na), Enq(state_st, ns)])
                    return Fused(Deq(state_st), on_state)
                yield Fused(Deq(val_st), on_v)

    return access_gen, exec_gen


# ---------------------------------------------------------------------------
# Benchmark: binsearch / binsearch_for
# ---------------------------------------------------------------------------


def _chan_cap(rif: int, cap: Optional[int]) -> int:
    """Channel capacity: explicit override (the tuner's knob) or the
    legacy rif+1 sizing."""
    return cap if cap is not None else rif + 1


def _binsearch_phases(data, config, early, latency, rif, mem_factory,
                      cap=None, shared_mems=None):
    arr, keys, n = data["arr"], data["keys"], data["n"]
    iters_fixed = int(math.ceil(math.log2(n)))
    shared_mems = shared_mems or {}
    mems = {
        "table": shared_mems.get("table")
        or mem_factory("table", list(arr)),
        "out": FixedLatencyMemory([None] * len(keys), latency),
    }

    def _mid(lo, hi):
        return (lo + hi) // 2 if lo < hi else min(lo, n - 1)

    def init_state(i):
        key = int(keys[i])
        lo, hi = 0, n
        return (i, key, lo, hi, -1, 1), _mid(lo, hi)

    def step(s, v):
        i, key, lo, hi, res, it = s
        mid = _mid(lo, hi)
        v = int(v)
        if early and v == key:
            return True, i, mid, None, 0
        if lo < hi:
            if v <= key:
                lo = mid + 1
            else:
                hi = mid
        if early:
            if lo >= hi:
                return True, i, -1, None, 0
        elif it >= iters_fixed:
            return True, i, lo, None, 0
        return False, 0, 0, (i, key, lo, hi, res, it + 1), _mid(lo, hi)

    def fixed_step(s, v):
        i, key, lo, hi, res, it = s
        mid = _mid(lo, hi)
        v = int(v)
        if early and v == key and res < 0:
            res = mid
        if lo < hi:
            if v <= key:
                lo = mid + 1
            else:
                hi = mid
        out = res if early else lo
        return i, out, (i, key, lo, hi, res, it + 1), _mid(lo, hi)

    ch = LoadChannel("bs_load", capacity=_chan_cap(rif, cap), port="table")
    st = StreamChannel("bs_state", capacity=_chan_cap(rif, cap))

    if config in ("vitis", "rhls"):
        ovh = VITIS_OVH if config == "vitis" else 0

        def gen():
            for i in range(len(keys)):
                s, addr = init_state(i)
                while True:
                    v = yield from _blocking_load(ch, addr, ovh)
                    done, oi, ov, s, addr = step(s, v)
                    if done:
                        yield Store("out", oi, ov)
                        break
        procs = [Process("coupled", gen)]
    elif config == "vitis_dec":
        gen = _lockstep_chase(ch, st, len(keys), iters_fixed, init_state,
                              fixed_step, "out", chunk=min(64, rif))
        procs = [Process("lockstep", gen, ii=VITIS_DEC_II)]
    elif config == "rhls_dec":
        gen = _roundrobin_chase(ch, st, len(keys), init_state, step, "out", rif)
        procs = [Process("roundrobin", gen)]
    elif config == "rhls_stream":
        if early:
            res, loads = binsearch_ref(arr, keys, True)
        else:
            res, loads = binsearch_ref(arr, keys, False)
        vst = StreamChannel("bs_vals", capacity=_chan_cap(rif, cap))
        a, e = _stream_chase(ch, vst, st, len(keys), loads, init_state, step,
                             "out", rif)
        procs = [Process("access", a), Process("execute", e)]
    else:
        raise ValueError(config)

    expected, golden_loads = binsearch_ref(arr, keys, early)

    def check(result: SimResult) -> bool:
        got = result.stored_array("out", len(keys))
        return all(g == e for g, e in zip(got, expected))

    return [DaeProgram(f"binsearch[{config}]", procs)], mems, golden_loads, check


# ---------------------------------------------------------------------------
# Compile-target workloads: gather / frontier_gather
#
# These are not Fig. 4 benchmarks; they exist as inputs to the
# repro_torch.compile pipeline (see repro/compile/targets.py).  gather mirrors
# the hand-written dae_gather kernel family so compiled-vs-handwritten
# cells are comparable; frontier_gather — one BFS frontier expansion
# step, out[k] = dist[adj[u_k, j]] — has NO hand-written kernel and
# lands end-to-end through the compiler alone.
# ---------------------------------------------------------------------------


def make_gather_data(scale: str, seed: int = 5) -> Dict[str, Any]:
    n, d, lookups = {
        "paper": (4_096, 128, 2_048),
        "small": (128, 8, 33),
    }[scale]
    r = _rng(seed)
    table = r.standard_normal((n, d)).astype(np.float32)
    idx = r.integers(0, n, size=lookups).astype(np.int64)
    return {"table": table, "idx": idx, "n": n, "d": d}


def gather_ref(table: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return table[idx]


def gather_phases(data, latency, rif, mem_factory, cap=None):
    """Decoupled row gather: a static Access stream + a copy Execute.

    Same ([programs], mems, golden_loads, check) shape as the
    benchmark ``_phases`` builders, so the simulator drives it
    unchanged; `repro_torch.compile` stages the identical program.
    """
    table, idx = data["table"], data["idx"]
    m = len(idx)
    mems = {
        "table": mem_factory("table", [row for row in table]),
        "out": FixedLatencyMemory([None] * m, latency),
    }
    ch = LoadChannel("ga_load", capacity=_chan_cap(rif, cap), port="table")

    def access():
        for a in idx:
            yield Req(ch, int(a))

    def execute():
        for j in range(m):
            yield Fused(Resp(ch), lambda v, j=j: Store("out", j, v))

    progs = [DaeProgram("gather[rhls_dec]",
                        [Process("access", access),
                         Process("execute", execute)])]
    expected = gather_ref(table, idx)

    def check(result: SimResult) -> bool:
        got = result.stored_array("out", m)
        return all(np.array_equal(g, e) for g, e in zip(got, expected))

    return progs, mems, m, check


def make_frontier_data(scale: str, seed: int = 6) -> Dict[str, Any]:
    n, deg, frontier_n = {
        "paper": (4_096, 16, 512),
        "small": (96, 4, 17),
    }[scale]
    r = _rng(seed)
    # Padded degree-`deg` adjacency; missing edges point at the sentinel
    # node n, whose dist entry is -1 (so the compiled kernel never needs
    # a divergent "skip this lane" branch — the paper's fixed-length
    # redundant-work trick applied to graph irregularity).
    adj = r.integers(0, n, size=(n, deg)).astype(np.int64)
    adj[r.random((n, deg)) < 0.25] = n
    dist = np.concatenate([r.integers(0, 64, size=n), [-1]]).astype(np.int64)
    frontier = r.choice(n, size=frontier_n, replace=False).astype(np.int64)
    return {"adj": adj, "dist": dist, "frontier": frontier, "n": n,
            "deg": deg}


def frontier_ref(adj: np.ndarray, dist: np.ndarray,
                 frontier: np.ndarray) -> np.ndarray:
    """One frontier-expansion step: the neighbour distances of every
    frontier node, in (node, edge-slot) order."""
    return dist[adj[frontier].ravel()]


def frontier_phases(data, latency, rif, mem_factory, cap=None):
    """BFS frontier expansion as a two-channel DAE program.

    Access issues the (static) flattened adjacency addresses of the
    frontier; a deref stage turns each landed neighbour id into a
    ``dist`` request (the one-hop indirect load, ``dist[adj[...]]``);
    Execute stores the landed distances.
    """
    adj, dist, frontier = data["adj"], data["dist"], data["frontier"]
    deg = data["deg"]
    m = len(frontier) * deg
    mems = {
        "adj": mem_factory("adj", [int(v) for v in adj.ravel()]),
        "dist": mem_factory("dist", [int(v) for v in dist]),
        "out": FixedLatencyMemory([None] * m, latency),
    }
    adj_ch = LoadChannel("fg_adj", capacity=_chan_cap(rif, cap),
                         port="adj")
    dist_ch = LoadChannel("fg_dist", capacity=_chan_cap(rif, cap),
                          port="dist")

    def access():
        for u in frontier:
            for j in range(deg):
                yield Req(adj_ch, int(u) * deg + j)

    def deref():
        for _ in range(m):
            v = yield Resp(adj_ch)
            yield Req(dist_ch, int(v))

    def execute():
        for k in range(m):
            yield Fused(Resp(dist_ch), lambda v, k=k: Store("out", k, v))

    progs = [DaeProgram("frontier_gather[rhls_dec]",
                        [Process("access", access),
                         Process("deref", deref),
                         Process("execute", execute)])]
    expected = frontier_ref(adj, dist, frontier)

    def check(result: SimResult) -> bool:
        got = result.stored_array("out", m)
        return all(int(g) == int(e) for g, e in zip(got, expected))

    return progs, mems, 2 * m, check


def spmv_gather_ref(cols: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """The decoupled vec-gather phase of SPMV: vec[cols[p]] per nnz."""
    return vec[cols]


def spmv_gather_phases(data, latency, rif, mem_factory, cap=None):
    """SPMV's decoupled vector fetch as a two-channel DAE program.

    The paper's Listing 2 decouples the *products* from the row-pointer
    loads; the irregular half of that kernel is the ``vec[cols[p]]``
    gather, which is what lowers onto the ring emitter (the accumulation
    is a dense reduction the compiler's store checker rejects — see
    ``repro_torch.compile``).  Access issues the (static) ``cols`` addresses;
    a deref stage turns each landed column id into a ``vec`` request;
    Execute stores the landed vector values in nnz order.
    """
    # float32: the compiled kernel stages port data through float32
    # VMEM, so the staged values must survive that cast exactly
    cols, vec = data["cols"], data["vec"].astype(np.float32)
    m = len(cols)
    mems = {
        "cols": mem_factory("cols", [int(c) for c in cols]),
        "vec": mem_factory("vec", [float(v) for v in vec]),
        "out": FixedLatencyMemory([None] * m, latency),
    }
    cols_ch = LoadChannel("sg_cols", capacity=_chan_cap(rif, cap),
                          port="cols")
    vec_ch = LoadChannel("sg_vec", capacity=_chan_cap(rif, cap),
                         port="vec")

    def access():
        for p in range(m):
            yield Req(cols_ch, p)

    def deref():
        for _ in range(m):
            c = yield Resp(cols_ch)
            yield Req(vec_ch, int(c))

    def execute():
        for p in range(m):
            yield Fused(Resp(vec_ch), lambda v, p=p: Store("out", p, v))

    progs = [DaeProgram("spmv_gather[rhls_dec]",
                        [Process("access", access),
                         Process("deref", deref),
                         Process("execute", execute)])]
    expected = spmv_gather_ref(cols, vec)

    def check(result: SimResult) -> bool:
        got = result.stored_array("out", m)
        return all(float(g) == float(e) for g, e in zip(got, expected))

    return progs, mems, 2 * m, check


def make_gmm_data(scale: str, seed: int = 8) -> Dict[str, Any]:
    nblocks, d, f, e = {
        "paper": (256, 8, 8, 16),
        "small": (24, 4, 4, 6),
    }[scale]
    r = _rng(seed)
    block_expert = r.integers(0, e, size=nblocks).astype(np.int64)
    # force at least one empty expert group — the routing edge the
    # kernel (and its Pallas twin) must survive without special-casing
    block_expert[block_expert == e - 1] = 0
    x = r.standard_normal((nblocks, d))
    w = r.standard_normal((e, d, f))
    return {"x": x, "w": w, "block_expert": block_expert, "e": e}


def gmm_ref(x: np.ndarray, w: np.ndarray,
            block_expert: np.ndarray) -> np.ndarray:
    """Per-block expert matmul: out[i] = x[i] @ w[block_expert[i]]."""
    return np.stack([x[i] @ w[int(eid)]
                     for i, eid in enumerate(block_expert)])


def gmm_phases(data, latency, rif, mem_factory, cap=None):
    """Grouped expert matmul as a two-channel DAE program — the
    simulator twin of ``repro_torch.kernels.grouped_matmul``.

    Access issues the (static) routing-stream addresses; a deref stage
    turns each landed expert id into a weight-table request (the
    irregular, data-dependent load — the same address stream the Pallas
    kernel's weight ring fetches ``rif`` tiles ahead); Execute multiplies
    the landed expert weights into the block's tokens and stores the
    block product.
    """
    x, w, block_expert = data["x"], data["w"], data["block_expert"]
    nb = len(block_expert)
    mems = {
        "route": mem_factory("route", [int(v) for v in block_expert]),
        "wtab": mem_factory("wtab", [w[j] for j in range(len(w))]),
        "out": FixedLatencyMemory([None] * nb, latency),
    }
    route_ch = LoadChannel("gm_route", capacity=_chan_cap(rif, cap),
                           port="route")
    w_ch = LoadChannel("gm_w", capacity=_chan_cap(rif, cap), port="wtab")

    def access():
        for i in range(nb):
            yield Req(route_ch, i)

    def deref():
        for _ in range(nb):
            v = yield Resp(route_ch)
            yield Req(w_ch, int(v))

    def execute():
        for i in range(nb):
            yield Fused(Resp(w_ch),
                        lambda wt, i=i: Store("out", i, x[i] @ wt))

    progs = [DaeProgram("grouped_matmul[rhls_dec]",
                        [Process("access", access),
                         Process("deref", deref),
                         Process("execute", execute)])]
    expected = gmm_ref(x, w, block_expert)

    def check(result: SimResult) -> bool:
        got = result.stored_array("out", nb)
        return all(np.array_equal(g, e) for g, e in zip(got, expected))

    return progs, mems, 2 * nb, check


# ---------------------------------------------------------------------------
# Benchmark: hashtable
# ---------------------------------------------------------------------------


def _hashtable_phases(data, config, latency, rif, mem_factory, cap=None,
                      shared_mems=None):
    entries, keys, heads = data["entries"], data["keys"], data["heads"]
    chain_len = data["chain_len"]
    shared_mems = shared_mems or {}
    mems = {
        "table": shared_mems.get("table")
        or mem_factory("table", list(entries)),
        "out": FixedLatencyMemory([None] * len(keys), latency),
    }

    def init_state(i):
        # hash computation -> head bucket
        return (i, keys[i]), heads[i]

    def step(s, entry):
        i, key = s
        k, v, nxt = entry
        if k == key:
            return True, i, v, None, 0
        if nxt < 0:
            return True, i, -1, None, 0
        return False, 0, 0, (i, key), nxt

    def fixed_step(s, entry):
        # lock-step variant: walk exactly chain_len steps; keep re-loading
        # the tail once resolved (redundant loads, paper §4.2)
        if len(s) == 2:
            s = (s[0], s[1], -1, heads[s[0]])
        i, key, res, idx = s
        k, v, nxt = entry
        if k == key and res < 0:
            res = v
        naddr = nxt if nxt >= 0 else idx
        return i, res, (i, key, res, naddr), naddr

    ch = LoadChannel("ht_load", capacity=_chan_cap(rif, cap), port="table")
    st = StreamChannel("ht_state", capacity=_chan_cap(rif, cap))

    if config in ("vitis", "rhls"):
        ovh = VITIS_OVH if config == "vitis" else 0

        def gen():
            for i in range(len(keys)):
                yield Delay(1)  # hash computation
                s, addr = init_state(i)
                while True:
                    v = yield from _blocking_load(ch, addr, ovh)
                    done, oi, ov, s, addr = step(s, v)
                    if done:
                        yield Store("out", oi, ov)
                        break
        procs = [Process("coupled", gen)]
    elif config == "vitis_dec":
        gen = _lockstep_chase(ch, st, len(keys), chain_len, init_state,
                              fixed_step, "out", chunk=min(64, rif))
        procs = [Process("lockstep", gen, ii=VITIS_DEC_II)]
    elif config == "rhls_dec":
        gen = _roundrobin_chase(ch, st, len(keys), init_state, step, "out", rif)
        procs = [Process("roundrobin", gen)]
    elif config == "rhls_stream":
        expected, loads = hashtable_ref(entries, keys, heads)
        vst = StreamChannel("ht_vals", capacity=_chan_cap(rif, cap))
        a, e = _stream_chase(ch, vst, st, len(keys), loads, init_state, step,
                             "out", rif)
        procs = [Process("access", a), Process("execute", e)]
    else:
        raise ValueError(config)

    expected, golden_loads = hashtable_ref(entries, keys, heads)

    def check(result: SimResult) -> bool:
        got = result.stored_array("out", len(keys))
        return all(g == e for g, e in zip(got, expected))

    return [DaeProgram(f"hashtable[{config}]", procs)], mems, golden_loads, check


# ---------------------------------------------------------------------------
# Benchmark: spmv (paper Listing 2) — also used by multispmv
# ---------------------------------------------------------------------------


def _spmv_program(rows, cols, val, vec_data, out_data, config, latency, rif,
                  mem_factory, tag="spmv", store_gate=0, cap=None,
                  shared_mems=None):
    """Build one SPMV DaeProgram writing results to out_data via port 'out'."""
    nrows = len(rows) - 1
    nnz = int(rows[-1])
    row_cnt = [int(rows[i + 1] - rows[i]) for i in range(nrows)]

    # Buffer sizing mirrors the paper's profile-guided approach (§6): the
    # val responses are consumed one val->vec round trip (~2x latency)
    # after issue, so that channel's buffer must cover the lag.
    c = _chan_cap(rif, cap)
    # with an explicit capacity the tuner owns the profile floors too
    val_cap = c if cap is not None else max(c, 2 * latency + 8)
    vec_cap = c if cap is not None else max(c, latency + 8)
    rows_ch = LoadChannel(f"{tag}_rows", capacity=c, port="rows")
    val_ch = LoadChannel(f"{tag}_val", capacity=val_cap, port="val")
    cols_ch = LoadChannel(f"{tag}_cols", capacity=c, port="cols")
    vec_ch = LoadChannel(f"{tag}_vec", capacity=vec_cap, port="vec")
    bounds_exec = StreamChannel(f"{tag}_bexec", capacity=nrows + 2)
    bounds_addr = StreamChannel(f"{tag}_baddr", capacity=nrows + 2)

    shared_mems = shared_mems or {}

    def _mem(port, build_data):
        return shared_mems.get(port) or mem_factory(port, build_data())

    mems = {
        "rows": _mem("rows", lambda: list(int(x) for x in rows)),
        "val": _mem("val", lambda: list(float(x) for x in val)),
        "cols": _mem("cols", lambda: list(int(x) for x in cols)),
        "vec": _mem("vec", lambda: vec_data),
        "out": FixedLatencyMemory(out_data, latency),
    }

    if config == "vitis":
        # static schedule: blocking row-pointer loads, FP-II-bound inner loop,
        # pipeline fill per row; values computed through the arrays.
        def gen():
            prev = yield from _blocking_load(rows_ch, 0, 0)
            for i in range(nrows):
                b = yield from _blocking_load(rows_ch, i + 1, 0)
                yield Delay(VITIS_ROW_FILL)
                s = 0.0
                for j in range(int(prev), int(b)):
                    s += val[j] * vec_data[int(cols[j])]
                    yield Delay(VITIS_FP_II)
                yield Store("out", i, s)
                prev = b
        return DaeProgram(f"{tag}[vitis]", [Process("spmv", gen)]), mems

    gated_addr = config in ("rhls",)  # request loop gated by rows (false dep)
    exec_ii = VITIS_DEC_II if config == "vitis_dec" else 1

    def p_rows():
        for i in range(nrows + 1):
            yield Req(rows_ch, i)

    def p_bounds():
        prev_cell = {"v": None}
        for i in range(nrows + 1):
            def on(v, prev_cell=prev_cell):
                if prev_cell["v"] is None:
                    prev_cell["v"] = int(v)
                    return None
                cnt = int(v) - prev_cell["v"]
                prev_cell["v"] = int(v)
                if gated_addr:
                    return Par([Enq(bounds_exec, cnt), Enq(bounds_addr, cnt)])
                return Enq(bounds_exec, cnt)
            yield Fused(Resp(rows_ch), on)

    def p_addr_gated():
        # rhls: address generation consumes a row-boundary token per row
        for i in range(nrows):
            cnt_cell = {}
            def on(c, cnt_cell=cnt_cell):
                cnt_cell["c"] = int(c)
                return None
            yield Fused(Deq(bounds_addr), on)
            for j in range(int(rows[i]), int(rows[i + 1])):
                yield Par([Req(val_ch, j), Req(cols_ch, j)])

    def p_addr_free():
        # decoupled: the false dependency through rows is gone (Listing 2 right)
        for j in range(nnz):
            yield Par([Req(val_ch, j), Req(cols_ch, j)])

    def p_vec():
        for j in range(nnz):
            yield Fused(Resp(cols_ch), lambda c: Req(vec_ch, int(c)))

    def p_exec():
        for i in range(nrows):
            cnt = row_cnt[i]
            if cnt == 0:
                yield Fused(Deq(bounds_exec), lambda _b, i=i: Store("out", i, 0.0))
                if store_gate:
                    yield Delay(store_gate)
                continue
            acc = {"s": 0.0}
            for j in range(cnt):
                first, lastj = j == 0, j == cnt - 1
                def on(vals, acc=acc, i=i, lastj=lastj):
                    v, x = float(vals[0]), float(vals[1])
                    acc["s"] += v * x
                    if lastj:
                        return Store("out", i, acc["s"])
                    return None
                subs = [Resp(val_ch), Resp(vec_ch)]
                if first:
                    subs.append(Deq(bounds_exec))
                yield Fused(Par(subs), on)
            if store_gate:
                yield Delay(store_gate)

    procs = [
        Process("rows_req", p_rows),
        Process("bounds", p_bounds),
        Process("addr", p_addr_gated if gated_addr else p_addr_free),
        Process("vec_req", p_vec),
        Process("exec", p_exec, ii=exec_ii),
    ]
    return DaeProgram(f"{tag}[{config}]", procs), mems


def _spmv_phases(data, config, latency, rif, mem_factory, cap=None,
                 shared_mems=None):
    rows, cols, val, vec = data["rows"], data["cols"], data["val"], data["vec"]
    if shared_mems and "vec" in shared_mems:
        vec_data = shared_mems["vec"].data
    else:
        vec_data = list(float(x) for x in vec)
    out_data = [0.0] * data["nrows"]
    prog, mems = _spmv_program(rows, cols, val, vec_data, out_data, config,
                               latency, rif, mem_factory, cap=cap,
                               shared_mems=shared_mems)
    expected = spmv_ref(rows, cols, val, vec)

    def check(result: SimResult) -> bool:
        got = np.array(out_data, dtype=np.float64)
        return bool(np.allclose(got, expected, rtol=1e-9, atol=1e-12))

    golden = data["nnz"]
    return [(prog, mems)], golden, check


# ---------------------------------------------------------------------------
# Benchmark: mergesort / mergesort_opt (paper Listing 3)
# ---------------------------------------------------------------------------


def _merge_pass_program(src_data, dst_data, n, width, config, latency, rif,
                        mem_factory, src_port, dst_port, cap=None, base=0,
                        mems=None):
    """One bottom-up pass: merge width-runs of src into 2*width-runs of dst.

    ``base`` offsets every address by a fixed amount so multiple tenants
    can sort disjoint ranges of one shared array; ``mems`` supplies
    pre-built (shared) memory models instead of creating private ones.
    """
    merges = []
    lo = 0
    while lo < n:
        merges.append((base + lo, base + min(lo + width, n),
                       base + min(lo + 2 * width, n)))
        lo += 2 * width

    # Vitis burst_maxi: only one request/response pair outstanding per
    # pointer at a time for data-dependent consumption order (§5.2)
    ch_cap = 1 if config == "vitis_dec" else _chan_cap(rif, cap)
    i_ch = LoadChannel(f"ms_i_{src_port}", capacity=ch_cap, port=src_port)
    j_ch = LoadChannel(f"ms_j_{src_port}", capacity=ch_cap, port=src_port)

    if mems is None:
        mems = {
            src_port: mem_factory(src_port, src_data),
            dst_port: mem_factory(dst_port, dst_data),
        }

    if config in ("vitis", "rhls"):
        ovh = VITIS_OVH if config == "vitis" else 0

        def gen():
            for (l, r, e) in merges:
                i, j = l, r
                for k in range(l, e):
                    reqs, resps = [], []
                    if i < r:
                        reqs.append(Req(i_ch, i))
                        resps.append(Resp(i_ch))
                    if j < e:
                        reqs.append(Req(j_ch, j))
                        resps.append(Resp(j_ch))
                    yield Par(reqs)
                    vals = yield Par(resps)
                    if ovh:
                        yield Delay(ovh)
                    vi = vals[0] if i < r else None
                    vj = vals[-1] if j < e else None
                    if j >= e or (i < r and vi <= vj):
                        yield Store(dst_port, k, vi)
                        i += 1
                    else:
                        yield Store(dst_port, k, vj)
                        j += 1
        return DaeProgram(f"merge[{config}]", [Process("merge", gen)]), mems

    # decoupled variants: request loops run ahead across the whole pass
    def p_req_i():
        for (l, r, e) in merges:
            for idx in range(l, r):
                yield Req(i_ch, idx)

    def p_req_j():
        for (l, r, e) in merges:
            for idx in range(r, e):
                yield Req(j_ch, idx)

    def p_merge():
        for (l, r, e) in merges:
            ni, nj = r - l, e - r
            state = {"hi": None, "hj": None, "ti": 0, "tj": 0}

            def pick_and_store(k, state=state):
                hi, hj = state["hi"], state["hj"]
                i_alive = hi is not None
                j_alive = hj is not None
                if i_alive and (not j_alive or hi <= hj):
                    state["hi"] = None
                    return Store(dst_port, k, hi)
                state["hj"] = None
                return Store(dst_port, k, hj)

            for k in range(l, e):
                need_i = state["hi"] is None and state["ti"] < ni
                need_j = state["hj"] is None and state["tj"] < nj
                if need_i and need_j:
                    def on_both(vals, k=k, state=state):
                        state["hi"], state["hj"] = vals
                        state["ti"] += 1
                        state["tj"] += 1
                        return pick_and_store(k)
                    yield Fused(Par([Resp(i_ch), Resp(j_ch)]), on_both)
                elif need_i:
                    def on_i(v, k=k, state=state):
                        state["hi"] = v
                        state["ti"] += 1
                        return pick_and_store(k)
                    yield Fused(Resp(i_ch), on_i)
                elif need_j:
                    def on_j(v, k=k, state=state):
                        state["hj"] = v
                        state["tj"] += 1
                        return pick_and_store(k)
                    yield Fused(Resp(j_ch), on_j)
                else:
                    yield pick_and_store(k)

    ii = VITIS_DEC_II if config == "vitis_dec" else 1
    procs = [
        Process("req_i", p_req_i),
        Process("req_j", p_req_j),
        Process("merge", p_merge, ii=ii),
    ]
    return DaeProgram(f"merge[{config}]", procs), mems


def _copy_pass_program(src_data, dst_data, n, config, latency, rif,
                       mem_factory, src_port, dst_port, cap=None, base=0,
                       mems=None):
    ch = LoadChannel(f"cp_{src_port}", capacity=_chan_cap(rif, cap),
                     port=src_port)
    if mems is None:
        mems = {
            src_port: mem_factory(src_port, src_data),
            dst_port: mem_factory(dst_port, dst_data),
        }
    if config in ("vitis",):
        def gen():
            yield Delay(latency)  # burst fill
            for k in range(base, base + n):
                yield Delay(2)
                yield Store(dst_port, k, src_data[k])
        return DaeProgram("copy[vitis]", [Process("copy", gen)]), mems

    def p_req():
        for k in range(base, base + n):
            yield Req(ch, k)

    def p_copy():
        for k in range(base, base + n):
            yield Fused(Resp(ch), lambda v, k=k: Store(dst_port, k, v))

    ii = VITIS_DEC_II if config == "vitis_dec" else 1
    return (
        DaeProgram(f"copy[{config}]",
                   [Process("req", p_req), Process("copy", p_copy, ii=ii)]),
        mems,
    )


def _mergesort_stream_deadlock() -> None:
    # The disambiguation scheme couples the two fetch loops through one
    # shared in-order queue; once run width exceeds the queue capacity
    # the merge needs the j-run head while i-run values block the
    # queue -> structural deadlock (paper §6).  We reproduce the
    # detection rather than modelling the hang.
    raise DeadlockError(
        "R-HLS Stream mergesort: shared disambiguation queue between "
        "the two fetch loops deadlocks (paper §6)")


def _mergesort_plan(table, result, n, opt):
    """Bottom-up phase plan over two buffers: a list of
    ``(kind, src, dst, width, src_port, dst_port)`` tuples plus the
    buffer that holds the sorted data afterwards and the merge-pass
    count.  The non-opt variant copies back after every merge; the opt
    variant ping-pongs the buffers instead (§4.2)."""
    phases = []
    width = 1
    src, dst = table, result
    src_port, dst_port = "table", "result"
    while width < n:
        phases.append(("merge", src, dst, width, src_port, dst_port))
        if opt:
            src, dst = dst, src
            src_port, dst_port = dst_port, src_port
        else:
            phases.append(("copy", dst, src, None, dst_port, src_port))
        width *= 2
    passes = len([p for p in phases if p[0] == "merge"])
    return phases, src, passes


def _mergesort_phases(data, config, opt, latency, rif, mem_factory, cap=None):
    n = data["n"]
    table = [int(x) for x in data["table"]]
    result = [0] * n

    if config == "rhls_stream":
        return _mergesort_stream_deadlock, None, None

    phases, final_holder, passes = _mergesort_plan(table, result, n, opt)
    golden = n * passes
    expected = np.sort(data["table"])

    def build():
        out = []
        for kind, s, d, w, sp, dp in phases:
            if kind == "merge":
                out.append(_merge_pass_program(s, d, n, w, config, latency,
                                               rif, mem_factory, sp, dp,
                                               cap=cap))
            else:
                out.append(_copy_pass_program(s, d, n, config, latency, rif,
                                              mem_factory, sp, dp, cap=cap))
        return out

    def check(_result) -> bool:
        got = np.array(final_holder, dtype=np.int64)
        return bool(np.array_equal(got, expected))

    return build, golden, check


# ---------------------------------------------------------------------------
# Benchmark: multispmv
# ---------------------------------------------------------------------------


def _multispmv_phases(data, config, latency, rif, mem_factory, cap=None):
    rows, cols, val = data["rows"], data["cols"], data["val"]
    nrows, nnz, iters, alpha = (data["nrows"], data["nnz"], data["iters"],
                                data["alpha"])
    vec_data = [float(x) for x in data["vec"]]
    out_data = [0.0] * nrows
    store_gate = RHLS_STORE_GATE if config == "rhls" else 0

    def build():
        progs = []
        for it in range(iters):
            progs.append(_spmv_program(rows, cols, val, vec_data, out_data,
                                       config, latency, rif, mem_factory,
                                       tag=f"mspmv{it}", store_gate=store_gate,
                                       cap=cap))
            progs.append(_scale_copy_program(out_data, vec_data, nrows, alpha,
                                             config, latency, rif, mem_factory,
                                             cap=cap))
        return progs

    expected = multispmv_ref(rows, cols, val, data["vec"], iters, alpha)
    golden = iters * nnz

    def check(_r) -> bool:
        got = np.array(vec_data, dtype=np.float64)
        return bool(np.allclose(got, expected, rtol=1e-9, atol=1e-12))

    return build, golden, check


def _scale_copy_program(out_data, vec_data, n, alpha, config, latency, rif,
                        mem_factory, cap=None):
    ch = LoadChannel("msc_out", capacity=_chan_cap(rif, cap), port="outr")
    mems = {
        "outr": mem_factory("outr", out_data),
        "vecw": mem_factory("vecw", vec_data),
    }
    if config == "vitis":
        def gen():
            yield Delay(latency)
            for k in range(n):
                yield Delay(2)
                yield Store("vecw", k, out_data[k] * alpha)
            yield StoreWait("vecw")
        return DaeProgram("scalecopy[vitis]", [Process("copy", gen)]), mems

    def p_req():
        for k in range(n):
            yield Req(ch, k)

    def p_copy():
        for k in range(n):
            yield Fused(Resp(ch), lambda v, k=k: Store("vecw", k, float(v) * alpha))
        yield StoreWait("vecw")

    ii = VITIS_DEC_II if config == "vitis_dec" else 1
    extra_hop = 1 if config == "rhls_stream" else 0

    def p_copy_stream():
        vst = StreamChannel("msc_vst", capacity=_chan_cap(rif, cap))
        # emulated as II=2: resp->enq then deq->store in one unit
        for k in range(n):
            v = yield Resp(ch)
            yield Store("vecw", k, float(v) * alpha)
        yield StoreWait("vecw")

    copy_proc = (Process("copy", p_copy_stream) if extra_hop
                 else Process("copy", p_copy, ii=ii))
    return (DaeProgram(f"scalecopy[{config}]",
                       [Process("req", p_req), copy_proc]), mems)


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WorkloadReport:
    benchmark: str
    config: str
    scale: str
    cycles: int
    golden: int
    overhead: float          # cycles/golden - 1
    correct: bool
    mem_reads: Dict[str, int]
    trace: Optional[TraceSummary] = None

    @property
    def speedup_base(self) -> Optional[float]:
        return None


def _mem_factory_for(kind: str, latency: int, max_outstanding: Optional[int],
                     moms_ports: Sequence[str]):
    """``max_outstanding=None`` -> the paper's defaults: the abstract
    fixed-latency Verilator model is unbounded, the MOMS AXI interface
    allows 64 outstanding reads (§6)."""

    def make(port: str, data: Any) -> MemoryModel:
        if kind == "moms" and port in moms_ports:
            return MomsMemory(data, max_outstanding=max_outstanding or 64)
        return FixedLatencyMemory(
            data, latency=latency,
            max_outstanding=max_outstanding or 1_000_000_000)
    return make


# ports holding the irregularly accessed data (paper: MOMS only for these)
MOMS_PORTS = {
    "binsearch": ("table",),
    "binsearch_for": ("table",),
    "hashtable": ("table",),
    "spmv": ("vec",),
    "multispmv": ("vec",),
    "mergesort": ("table", "result"),
    "mergesort_opt": ("table", "result"),
}


def run_workload(
    benchmark: str,
    config: str,
    scale: str = "paper",
    mem: str = "fixed",
    latency: int = 100,
    rif: int = 128,
    max_outstanding: Optional[int] = None,
    seed: int = 0,
    cap_slack: Optional[int] = None,
    engine: str = "event",
    trace: bool = False,
    trace_bin_cycles: int = 64,
    tracer: Optional[Tracer] = None,
) -> WorkloadReport:
    """Build and simulate one (benchmark, config) cell of Table 1/3.

    ``cap_slack`` overrides the channel-capacity sizing: when given,
    load/stream channels get ``capacity = rif + cap_slack`` instead of
    the legacy per-benchmark defaults.  This is the knob ``repro_torch.tune``
    sweeps; too-small values reproduce the §5.3 deadlocks.

    ``engine`` selects the scheduler implementation (``"event"`` or the
    legacy ``"polling"`` oracle — bit-exact, see
    :mod:`repro_torch.core.simulator`).  With ``trace=True`` the report
    carries a :class:`repro_torch.core.trace.TraceSummary`; multi-phase
    benchmarks (mergesort, multispmv) accumulate across phases with
    per-phase clocks restarting at zero.

    An explicit ``tracer`` instance (e.g. a
    :class:`repro_torch.core.waveform.WaveformTracer` for full per-cycle
    timelines and VCD export) overrides the ``trace``/``trace_bin_cycles``
    construction and is driven through the same hooks.
    """
    if config not in CONFIGS:
        raise ValueError(f"unknown config {config!r}")
    cap = None if cap_slack is None else max(1, rif + cap_slack)
    mem_factory = _mem_factory_for(mem, latency, max_outstanding,
                                   MOMS_PORTS.get(benchmark, ()))
    if tracer is None:
        tracer = Tracer(trace_bin_cycles) if trace else None

    def _sim(prog, mems):
        return simulate(prog, mems, tracer=tracer, engine=engine)

    def _summary():
        return tracer.summary() if tracer is not None else None

    if benchmark in ("binsearch", "binsearch_for"):
        data = make_binsearch_data(scale, seed)
        early = benchmark == "binsearch"
        progs, mems, golden, check = _binsearch_phases(
            data, config, early, latency, rif, mem_factory, cap=cap)
        total = 0
        result = None
        for prog in progs:
            result = _sim(prog, mems)
            total += result.cycles
        reads = {p: m.reads for p, m in mems.items()}
        return WorkloadReport(benchmark, config, scale, total, golden,
                              total / golden - 1, check(result), reads,
                              _summary())

    if benchmark == "hashtable":
        data = make_hashtable_data(scale, seed)
        progs, mems, golden, check = _hashtable_phases(
            data, config, latency, rif, mem_factory, cap=cap)
        total = 0
        result = None
        for prog in progs:
            result = _sim(prog, mems)
            total += result.cycles
        reads = {p: m.reads for p, m in mems.items()}
        return WorkloadReport(benchmark, config, scale, total, golden,
                              total / golden - 1, check(result), reads,
                              _summary())

    if benchmark == "spmv":
        data = make_spmv_data(scale if scale != "paper" else "paper", seed)
        cells, golden, check = _spmv_phases(data, config, latency, rif,
                                            mem_factory, cap=cap)
        total = 0
        reads: Dict[str, int] = {}
        for prog, mems in cells:
            r = _sim(prog, mems)
            total += r.cycles
            for p, m in mems.items():
                reads[p] = reads.get(p, 0) + m.reads
        return WorkloadReport(benchmark, config, scale, total, golden,
                              total / golden - 1, check(None), reads,
                              _summary())

    if benchmark in ("mergesort", "mergesort_opt"):
        data = make_mergesort_data(scale, seed)
        opt = benchmark == "mergesort_opt"
        build, golden, check = _mergesort_phases(data, config, opt, latency,
                                                 rif, mem_factory, cap=cap)
        if golden is None:  # rhls_stream structural deadlock
            build()  # raises DeadlockError
        total = 0
        reads = {}
        for prog, mems in build():
            r = _sim(prog, mems)
            total += r.cycles
            for p, m in mems.items():
                reads[p] = reads.get(p, 0) + m.reads
        return WorkloadReport(benchmark, config, scale, total, golden,
                              total / golden - 1, check(None), reads,
                              _summary())

    if benchmark == "multispmv":
        data = make_multispmv_data("paper" if scale in ("paper", "fig4") else scale,
                                   seed)
        build, golden, check = _multispmv_phases(data, config, latency, rif,
                                                 mem_factory, cap=cap)
        total = 0
        reads = {}
        for prog, mems in build():
            r = _sim(prog, mems)
            total += r.cycles
            for p, m in mems.items():
                reads[p] = reads.get(p, 0) + m.reads
        return WorkloadReport(benchmark, config, scale, total, golden,
                              total / golden - 1, check(None), reads,
                              _summary())

    raise ValueError(f"unknown benchmark {benchmark!r}")


# ---------------------------------------------------------------------------
# Multi-tenant variants: N program instances, one shared memory system
# ---------------------------------------------------------------------------

# ports the tenants share (contended) per benchmark; every other port
# referenced by a program is private to its instance
MULTI_SHARED_PORTS = {
    "binsearch": ("table",),
    "binsearch_for": ("table",),
    "hashtable": ("table",),
    "spmv": ("rows", "val", "cols", "vec"),
    "mergesort": ("table", "result"),
    "mergesort_opt": ("table", "result"),
}
MULTI_BENCHMARKS = tuple(MULTI_SHARED_PORTS)


@dataclasses.dataclass
class MultiWorkloadReport:
    """One multi-tenant simulation: N instances of a benchmark sharing
    the irregular-data memory port(s)."""

    benchmark: str
    config: str
    scale: str
    n_instances: int
    cycles: int                      # makespan across instances
    per_instance_cycles: List[int]
    golden: int                      # golden loads summed over instances
    correct: bool
    mem_reads: Dict[str, int]
    trace: Optional[TraceSummary] = None

    @property
    def throughput_per_instance(self) -> float:
        """Golden work items retired per cycle per tenant — the quantity
        whose degradation with N the ``scale`` benchmark reports."""
        return (self.golden / self.n_instances) / max(1, self.cycles)


def _tenant_binsearch_data(data0: Dict[str, Any], i: int,
                           seed: int) -> Dict[str, Any]:
    """Tenant i queries the SAME sorted table with its own key set."""
    if i == 0:
        return data0
    r = _rng(seed + 7919 * i)
    keys = data0["arr"][r.integers(0, data0["n"], size=len(data0["keys"]))]
    return {**data0, "keys": keys}


def _tenant_hashtable_data(data0: Dict[str, Any], i: int,
                           seed: int) -> Dict[str, Any]:
    """Tenant i walks the SAME chains in its own (permuted) order."""
    if i == 0:
        return data0
    r = _rng(seed + 7919 * i)
    perm = r.permutation(data0["chains"])
    return {**data0,
            "keys": [data0["keys"][p] for p in perm],
            "heads": [data0["heads"][p] for p in perm]}


def _merge_reads(shared: Dict[str, MemoryModel],
                 privates: List[Dict[str, MemoryModel]]) -> Dict[str, int]:
    reads = {p: m.reads for p, m in shared.items()}
    for mems in privates:
        for p, m in mems.items():
            reads[p] = reads.get(p, 0) + m.reads
    return reads


def _multi_run_single_phase(instances, shared, checks, tracer, engine):
    res = SharedMemoryEngine(instances, shared, tracer=tracer,
                             engine=engine).run()
    correct = all(chk(r) for chk, r in zip(checks, res.instances))
    return res, correct


def run_workload_multi(
    benchmark: str,
    config: str,
    n_instances: int,
    *,
    scale: str = "small",
    mem: str = "fixed",
    latency: int = 100,
    rif: int = 128,
    max_outstanding: Optional[int] = None,
    seed: int = 0,
    cap_slack: Optional[int] = None,
    trace: bool = False,
    trace_bin_cycles: int = 64,
    engine: str = "event",
    tracer: Optional[Tracer] = None,
) -> MultiWorkloadReport:
    """Simulate ``n_instances`` concurrent tenants of one benchmark
    sharing the irregular-data port(s) of a single memory system.

    Tenants are independent program instances (own channels, own ``out``
    port) contending for the shared ports' issue slots and — under
    ``max_outstanding`` — one outstanding-request budget.  Read-only
    benchmarks (binsearch/hashtable/spmv) share the actual data arrays;
    the mergesorts give each tenant a disjoint range of one shared
    array.  ``n_instances == 1`` reproduces :func:`run_workload`'s cycle
    counts exactly.

    With ``trace=True`` the report carries a
    :class:`repro_torch.core.trace.TraceSummary` of per-channel occupancy,
    request-latency histograms, and shared-port utilization.  For
    multi-pass benchmarks (mergesort) the tracer accumulates across
    passes; pass-local times restart at zero, so port timelines overlay
    the passes rather than concatenating them.  ``engine`` selects the
    scheduler implementation (``"event"`` default, ``"polling"`` the
    bit-exact legacy oracle).
    """
    if config not in CONFIGS:
        raise ValueError(f"unknown config {config!r}")
    if benchmark not in MULTI_SHARED_PORTS:
        raise ValueError(
            f"benchmark {benchmark!r} has no multi-tenant variant "
            f"(supported: {MULTI_BENCHMARKS})")
    if n_instances < 1:
        raise ValueError("n_instances must be >= 1")
    cap = None if cap_slack is None else max(1, rif + cap_slack)
    mem_factory = _mem_factory_for(mem, latency, max_outstanding,
                                   MOMS_PORTS.get(benchmark, ()))
    if tracer is None:
        tracer = Tracer(trace_bin_cycles) if trace else None
    shared_ports = MULTI_SHARED_PORTS[benchmark]

    if benchmark in ("binsearch", "binsearch_for", "hashtable"):
        early = benchmark == "binsearch"
        if benchmark == "hashtable":
            data0 = make_hashtable_data(scale, seed)
            tenant = _tenant_hashtable_data
        else:
            data0 = make_binsearch_data(scale, seed)
            tenant = _tenant_binsearch_data
        shared: Optional[Dict[str, MemoryModel]] = None
        instances, checks, goldens, privates = [], [], [], []
        for i in range(n_instances):
            data = tenant(data0, i, seed)
            if benchmark == "hashtable":
                progs, mems, golden, check = _hashtable_phases(
                    data, config, latency, rif, mem_factory, cap=cap,
                    shared_mems=shared)
            else:
                progs, mems, golden, check = _binsearch_phases(
                    data, config, early, latency, rif, mem_factory, cap=cap,
                    shared_mems=shared)
            if shared is None:
                shared = {p: mems[p] for p in shared_ports}
            private = {p: m for p, m in mems.items() if p not in shared_ports}
            instances.append(EngineInstance(f"t{i}", progs[0], private))
            privates.append(private)
            checks.append(check)
            goldens.append(golden)
        res, correct = _multi_run_single_phase(instances, shared, checks,
                                               tracer, engine)
        return MultiWorkloadReport(
            benchmark, config, scale, n_instances, res.cycles,
            [r.cycles for r in res.instances], sum(goldens), correct,
            _merge_reads(shared, privates), res.trace)

    if benchmark == "spmv":
        data = make_spmv_data(scale, seed)
        shared = None
        instances, checks, privates = [], [], []
        for i in range(n_instances):
            cells, golden, check = _spmv_phases(data, config, latency, rif,
                                                mem_factory, cap=cap,
                                                shared_mems=shared)
            prog, mems = cells[0]
            if shared is None:
                shared = {p: mems[p] for p in shared_ports}
            private = {p: m for p, m in mems.items() if p not in shared_ports}
            instances.append(EngineInstance(f"t{i}", prog, private))
            privates.append(private)
            checks.append(lambda _r, chk=check: chk(None))
        res, correct = _multi_run_single_phase(instances, shared, checks,
                                               tracer, engine)
        return MultiWorkloadReport(
            benchmark, config, scale, n_instances, res.cycles,
            [r.cycles for r in res.instances],
            n_instances * data["nnz"], correct,
            _merge_reads(shared, privates), res.trace)

    # mergesort / mergesort_opt: each tenant sorts its own n-element range
    # of one shared table/result array pair; passes run phase-aligned
    # (every tenant's pass-k programs share one engine run)
    opt = benchmark == "mergesort_opt"
    if config == "rhls_stream":
        _mergesort_stream_deadlock()
    datas = [make_mergesort_data(scale, seed + i) for i in range(n_instances)]
    n = datas[0]["n"]
    big_table = [int(x) for d in datas for x in d["table"]]
    big_result = [0] * (n * n_instances)

    phases, final_holder, passes = _mergesort_plan(big_table, big_result, n,
                                                   opt)
    expected = [np.sort(d["table"]) for d in datas]

    total = 0
    per_inst = [0] * n_instances
    reads: Dict[str, int] = {}
    for kind, s, d, w, sp, dp in phases:
        shared = {sp: mem_factory(sp, s), dp: mem_factory(dp, d)}
        instances = []
        for i in range(n_instances):
            if kind == "merge":
                prog, _ = _merge_pass_program(s, d, n, w, config, latency,
                                              rif, mem_factory, sp, dp,
                                              cap=cap, base=i * n,
                                              mems=shared)
            else:
                prog, _ = _copy_pass_program(s, d, n, config, latency, rif,
                                             mem_factory, sp, dp, cap=cap,
                                             base=i * n, mems=shared)
            instances.append(EngineInstance(f"t{i}", prog))
        res = SharedMemoryEngine(instances, shared, tracer=tracer,
                                 engine=engine).run()
        total += res.cycles
        for i, r in enumerate(res.instances):
            per_inst[i] += r.cycles
        for p, m in shared.items():
            reads[p] = reads.get(p, 0) + m.reads

    correct = all(
        np.array_equal(np.array(final_holder[i * n:(i + 1) * n],
                                dtype=np.int64), expected[i])
        for i in range(n_instances))
    return MultiWorkloadReport(
        benchmark, config, scale, n_instances, total, per_inst,
        n_instances * n * passes, correct, reads,
        tracer.summary() if tracer is not None else None)
