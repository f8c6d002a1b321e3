"""Measurement backends for the tuner: the port's copy of
``repro.tune.runners``.

Two backends, matching the two halves of the port:

* **wallclock** — time the public dispatchers
  (``repro_torch/kernels/*/ops.py``).  On ``cuda`` (the default) the
  Hopper kernels run and CUDA events time them: the best of ``reps``
  calls after one warm call, each queued behind a device spin so that
  the host's launch path stays outside the events (the L2 stays warm).
  On ``device="cpu"`` the dispatchers run the kernels' plain versions
  and ``time.perf_counter`` times them: the numbers are plumbing only,
  as the reference's interpret mode is.
* **simulator** — cycle counts from :mod:`repro_torch.core.simulator` for
  the paper's DAE programs in :mod:`repro_torch.core.workloads`.
  Deterministic, bit-identical to the reference's simulator, and it
  surfaces the §5.3 deadlocks (propagated to the searcher, which maps
  them to an infinite score).

Every runner returns a ``measure(config) -> score`` callable (lower is
better) plus the canonical cache key for persisting the winner.  Input
data is built once per runner from ``np.random.default_rng(0)``, and
every measurement passes every knob explicitly, so a cache entry never
decides what is measured.  Each op is measured in the dtype its kernel
runs on the port's main paths (bfloat16 for attention and the expert
matmul), at auxiliary shapes of those paths (8 decode slots of 8 KV
heads, 64 experts top-6); the key carries the dims and the dtype.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bench.timing import SLEEP_CYCLES
from repro_torch.kernels.common import backend_tag, cdiv, resolve_device
from repro_torch.tune.cache import make_key
from repro_torch.tune.space import Config

__all__ = ["kernel_runner", "kernel_key", "compiled_runner",
           "workload_runner", "multi_workload_runner", "KERNEL_DIMS",
           "KERNEL_DTYPES", "backend_tag", "time_callable", "wallclock_tag",
           "SIM_BACKEND"]

# default problem dimensions per op: the reference's, so a CPU sweep
# finishes in seconds; the card is tuned at its main paths' shapes
KERNEL_DIMS: Dict[str, Tuple[int, ...]] = {
    "dae_gather": (2048, 256, 512),          # (n, d, m)
    "dae_merge": (2048, 2048),               # (n, m)
    "flash_attention": (256, 256, 64),       # (sq, sk, d_head)
    "flash_decode": (512, 64),               # (cache len, d_head)
    "flash_decode_paged": (64, 64),          # (page, d_head)
    "grouped_matmul": (256, 256, 256),       # (t, d, f)
    "batched_searchsorted": (4096, 256),     # (n, m)
    "hash_lookup": (4096, 256),              # (n entries, m keys)
    "dae_spmv": (256, 4096, 4096),           # (nrows, ncols, nnz)
}

# the dtype each op is measured (and keyed) in
KERNEL_DTYPES: Dict[str, str] = {
    "dae_gather": "float32", "dae_merge": "float32",
    "flash_attention": "bfloat16", "flash_decode": "bfloat16",
    "flash_decode_paged": "bfloat16", "grouped_matmul": "bfloat16",
    "batched_searchsorted": "int32", "hash_lookup": "int32",
    "dae_spmv": "float32",
}

# the simulator's backend in workload keys: not the reference's "sim"
SIM_BACKEND = "torch:sim"

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int32": torch.int32}


def _sync_time(fn: Callable[[], object]) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def time_callable(fn: Callable[[], object], reps: int = 3,
                  contenders: int = 1, *, device=None) -> float:
    """Best-of-``reps`` time of ``fn`` in seconds after one warm call.

    On ``cuda`` (``device=None`` is the card) CUDA events on the current
    stream bracket each call, and the device first spins for
    ``SLEEP_CYCLES`` (about a millisecond, as :class:`ColdTimer` does):
    the host has enqueued the call before the device reaches the start
    event, so only device time lies between the events, not the host's
    launch path.  ``contenders > 1`` launches ``fn`` on N CUDA streams
    together, each waiting on the start event, and scores the
    *makespan* (the start event to an end event after every stream) —
    the paper's §5.4 shared-memory contention regime applied to
    wall-clock tuning, mirroring the simulator's
    ``multi_workload_runner``.  On the CPU ``time.perf_counter``
    brackets each call, and N contenders run from N threads.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        if contenders <= 1:
            fn()
            return min(_sync_time(fn) for _ in range(reps))
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=contenders) as pool:
            def makespan() -> None:
                futs = [pool.submit(fn) for _ in range(contenders)]
                for fu in futs:
                    fu.result()
            makespan()
            return min(_sync_time(makespan) for _ in range(reps))

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    main = torch.cuda.current_stream(dev)
    streams = [torch.cuda.Stream(dev) for _ in range(max(contenders, 1) - 1)]

    def once() -> float:
        torch.cuda._sleep(SLEEP_CYCLES)       # on the current stream
        start.record(main)
        for s in streams:
            s.wait_event(start)
            with torch.cuda.stream(s):
                fn()
        fn()
        for s in streams:
            main.wait_stream(s)
        end.record(main)
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    once()
    return min(once() for _ in range(reps))


def wallclock_tag(contenders: int) -> str:
    """Cache-key mem tag for wall-clock runs: solo keeps the historical
    ``"wallclock"`` tag; contended runs key per-N (mirroring
    ``tune_workload(instances=N)``) so a winner measured under
    shared-memory contention never shadows the solo winner."""
    if contenders <= 1:
        return "wallclock"
    return f"wallclock:contenders={contenders}"


# ---------------------------------------------------------------------------
# Wall-clock kernel runners
# ---------------------------------------------------------------------------


def _on(a: np.ndarray, device, dtype: Optional[str] = None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t if dtype is None else t.to(_TORCH_DTYPES[dtype])


def _normal(r, shape, device, dtype="float32") -> torch.Tensor:
    return _on(r.standard_normal(shape, dtype=np.float32), device, dtype)


def _timed(run: Callable, ref: Callable, reps: int, contenders: int,
           device) -> Callable[[Config], float]:
    """The measure of a kernel runner: ``measure(cfg)`` times
    ``run(cfg)``; ``measure.run(None)`` dispatches the same inputs with
    every knob ``None`` (the tune cache decides), and ``measure.ref()``
    is the ``method="ref"`` oracle on them."""
    def measure(cfg: Config) -> float:
        return time_callable(lambda: run(cfg), reps, contenders,
                             device=device)

    measure.run, measure.ref = run, ref
    return measure


def _gather_measure(dims, device, reps, contenders=1):
    from repro_torch.kernels.dae_gather import dae_gather
    n, d, m = dims
    r = np.random.default_rng(0)
    table = _normal(r, (n, d), device)
    idx = _on(r.integers(0, n, m).astype(np.int32), device)

    def run(cfg: Optional[Config]):
        if cfg is None:
            return dae_gather(table, idx)
        # every knob explicit so the dispatcher never consults the cache
        # mid-measurement (a stale entry must not contaminate the search)
        return dae_gather(table, idx, method=cfg.get("method", "pipelined"),
                          block_d=512, chunk=cfg.get("chunk", 64),
                          rif=cfg.get("rif", 8))

    return _timed(run, lambda: dae_gather(table, idx, method="ref"), reps,
                  contenders, device)


def _merge_measure(dims, device, reps, contenders=1):
    from repro_torch.kernels.dae_merge import merge_sorted
    n, m = dims
    r = np.random.default_rng(0)
    a = torch.sort(_normal(r, n, device)).values
    b = torch.sort(_normal(r, m, device)).values

    def run(cfg: Optional[Config]):
        if cfg is None:
            return merge_sorted(a, b)
        return merge_sorted(a, b, tile=cfg["tile"], rif=cfg.get("rif", 2))

    return _timed(run, lambda: merge_sorted(a, b, method="ref"), reps,
                  contenders, device)


def _flash_measure(dims, device, reps, contenders=1):
    """granite's prefill heads: B 2, H 24 over KVH 8."""
    from repro_torch.kernels.flash_attention import flash_attention
    sq, sk, d = dims
    r = np.random.default_rng(0)
    q = _normal(r, (2, 24, sq, d), device, "bfloat16")
    k = _normal(r, (2, 8, sk, d), device, "bfloat16")
    v = _normal(r, (2, 8, sk, d), device, "bfloat16")

    def run(cfg: Optional[Config]):
        if cfg is None:
            return flash_attention(q, k, v)
        return flash_attention(q, k, v, bq=128, bk=128,
                               rif=cfg.get("rif", 2))

    return _timed(run, lambda: flash_attention(q, k, v, method="ref"), reps,
                  contenders, device)


_SLOTS, _KVH, _G = 8, 8, 4        # qwen3-4b's decode: 8 slots, 8 KV heads


def _lengths(r, s: int, device) -> torch.Tensor:
    """Ragged decode lengths in [1, s], the last slot full."""
    lens = r.integers(1, s + 1, _SLOTS).astype(np.int32)
    lens[-1] = s
    return _on(lens, device)


def _flash_decode_measure(dims, device, reps, contenders=1):
    from repro_torch.kernels.flash_attention import flash_decode
    s, d = dims
    r = np.random.default_rng(0)
    q = _normal(r, (_SLOTS, _KVH * _G, d), device, "bfloat16")
    kc = _normal(r, (_SLOTS, _KVH, s, d), device, "bfloat16")
    vc = _normal(r, (_SLOTS, _KVH, s, d), device, "bfloat16")
    lens = _lengths(r, s, device)

    def run(cfg: Optional[Config]):
        if cfg is None:
            return flash_decode(q, kc, vc, lens)
        return flash_decode(q, kc, vc, lens, bk=cfg["bk"],
                            rif=cfg.get("rif", 4))

    return _timed(run, lambda: flash_decode(q, kc, vc, lens, method="ref"),
                  reps, contenders, device)


def _flash_decode_paged_measure(dims, device, reps, contenders=1):
    """Requests of up to 1024 tokens (at least 4 pages) in a shuffled
    page pool."""
    from repro_torch.kernels.flash_attention import flash_decode_paged
    page, d = dims
    npb = max(4, cdiv(1024, page))
    r = np.random.default_rng(0)
    q = _normal(r, (_SLOTS, _KVH * _G, d), device, "bfloat16")
    kp = _normal(r, (_SLOTS * npb, _KVH, page, d), device, "bfloat16")
    vp = _normal(r, (_SLOTS * npb, _KVH, page, d), device, "bfloat16")
    pt = _on(r.permutation(_SLOTS * npb).astype(np.int32)
             .reshape(_SLOTS, npb), device)
    lens = _lengths(r, npb * page, device)

    def run(cfg: Optional[Config]):
        rif = None if cfg is None else cfg.get("rif", 4)
        return flash_decode_paged(q, kp, vp, pt, lens, rif=rif)

    return _timed(run, lambda: flash_decode_paged(q, kp, vp, pt, lens,
                                                  method="ref"),
                  reps, contenders, device)


_EXPERTS, _TOP_K, _BT = 64, 6, 128     # deepseek-v2-lite-16b's MoE


def _gmm_layout(t: int, r, device):
    """The blocks of a (t, d) expert-sorted input: (experts, block
    experts, block rows or None).  Where t is the MoE dispatch's static
    bound for some token count (``models.moe.block_layout``: the pairs
    rounded to whole blocks plus a block an expert), the tokens are a
    decode step's (8, or the fewest that give t) routed top-6 over 64
    experts at random, and the rows past each block's real ones are
    zero; otherwise 4 experts over whole blocks of real rows, as the
    reference measures."""
    from repro_torch.models.moe import block_layout
    rest = t - _EXPERTS * _BT
    if rest >= _BT and rest % _BT == 0:
        n = max(min(_SLOTS, rest // _TOP_K), (rest - _BT) // _TOP_K + 1)
        experts = np.argsort(r.random((n, _EXPERTS)), axis=1)[:, :_TOP_K]
        counts = np.bincount(experts.reshape(-1), minlength=_EXPERTS)
        tp, _, be, rows = block_layout(_on(counts, device), n * _TOP_K, _BT)
        if tp != t:
            raise RuntimeError(f"block layout of {tp} rows, wanted {t}")
        return _EXPERTS, be, rows
    nblk = cdiv(t, _BT)
    be = np.sort(r.integers(0, 4, nblk)).astype(np.int32)
    return 4, _on(be, device), None


def _gmm_measure(dims, device, reps, contenders=1):
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    t, d, f = dims
    r = np.random.default_rng(0)
    e, be, rows = _gmm_layout(t, r, device)
    x = _normal(r, (t, d), device, "bfloat16")
    if rows is not None:
        pos = torch.arange(t, device=device)
        x = x * (pos % _BT < rows.long()[pos // _BT])[:, None].to(x.dtype)
    w = _on(r.standard_normal((e, d, f), dtype=np.float32)
            * np.float32(d ** -0.5), device, "bfloat16")

    def run(cfg: Optional[Config]):
        if cfg is None:
            return grouped_matmul(x, w, be, bt=_BT, block_rows=rows)
        return grouped_matmul(x, w, be, bt=_BT, bf=cfg["bf"], bd=512,
                              block_rows=rows, rif=cfg.get("rif", 8))

    return _timed(run, lambda: grouped_matmul(x, w, be, bt=_BT,
                                              block_rows=rows,
                                              method="ref"),
                  reps, contenders, device)


def _searchsorted_measure(dims, device, reps, contenders=1):
    from repro_torch.kernels.dae_chase import batched_searchsorted
    n, m = dims
    r = np.random.default_rng(0)
    table = torch.sort(_on(r.integers(0, 1 << 30, n).astype(np.int32),
                           device)).values
    keys = _on(r.integers(0, 1 << 30, m).astype(np.int32), device)

    def run(cfg: Optional[Config]):
        if cfg is None:
            return batched_searchsorted(table, keys)
        return batched_searchsorted(table, keys, block=cfg["block"],
                                    chunk=cfg.get("chunk", 64),
                                    rif=cfg.get("rif", 4))

    return _timed(run, lambda: batched_searchsorted(table, keys,
                                                    method="ref"),
                  reps, contenders, device)


def _hash_measure(dims, device, reps, contenders=1):
    from repro_torch.kernels.dae_chase import hash_lookup
    n, m = dims
    chain = 8
    r = np.random.default_rng(0)
    ek = _on(np.arange(n, dtype=np.int32), device)
    ev = _on(r.integers(0, 1 << 20, n).astype(np.int32), device)
    nxt = np.arange(1, n + 1, dtype=np.int32)
    nxt[nxt % chain == 0] = -1
    en = _on(nxt, device)
    heads_np = (r.integers(0, n // chain, m) * chain).astype(np.int32)
    heads = _on(heads_np, device)
    keys = _on(heads_np + r.integers(0, chain, m).astype(np.int32), device)
    table = (ek, ev, en, heads, keys)

    def run(cfg: Optional[Config]):
        if cfg is None:
            return hash_lookup(*table, max_steps=chain)
        return hash_lookup(*table, max_steps=chain,
                           chunk=cfg.get("chunk", 64), rif=8)

    return _timed(run, lambda: hash_lookup(*table, max_steps=chain,
                                           method="ref"),
                  reps, contenders, device)


def _spmv_measure(dims, device, reps, contenders=1):
    from repro_torch.kernels.dae_spmv import csr_to_bsr, dae_spmv
    from repro_torch.kernels.dae_spmv.ref import spmv_ref
    nrows, ncols, nnz = dims
    r = np.random.default_rng(0)
    counts = r.multinomial(nnz, np.ones(nrows) / nrows)
    rows = np.zeros(nrows + 1, np.int64)
    rows[1:] = np.cumsum(counts)
    cols = r.integers(0, ncols, nnz)
    val = r.standard_normal(nnz).astype(np.float32)
    vec = _normal(r, ncols, device)
    converted: Dict[Tuple[int, int], tuple] = {}

    def bsr(bm: Optional[int], bk: Optional[int]):
        # one block shape at a time on the device: the search moves one
        # axis per step, so the last conversion serves the rif axis
        if (bm, bk) not in converted:
            converted.clear()
            vb, ri, ci, _, nrb = csr_to_bsr(rows, cols, val, ncols, bm=bm,
                                            bk=bk, device=device)
            converted[bm, bk] = (_on(vb, device), _on(ri, device),
                                 _on(ci, device), nrb)
        return converted[bm, bk]

    def run(cfg: Optional[Config]):
        # block shape is a conversion-time knob: conversion cost is NOT
        # timed (amortized over many matvecs), the matvec is
        if cfg is None:
            return dae_spmv(*bsr(None, None)[:3], vec, bsr(None, None)[3])
        vb, ri, ci, nrb = bsr(cfg["bm"], cfg["bk"])
        return dae_spmv(vb, ri, ci, vec, nrb, rif=cfg.get("rif", 2))

    def ref():
        return spmv_ref(_on(rows, device), _on(cols, device),
                        _on(val, device), vec)

    def alias_keys(best: Config):
        # csr_to_bsr dispatches its block shape under the CSR dims this
        # runner stores the winner at, but dae_spmv's rif lookup only
        # sees the *converted* operands — mirror the winner under the
        # BSR-dims key so the tuned rif actually dispatches.
        vb, _ri, _ci, _pad, nrb = csr_to_bsr(rows, cols, val, ncols,
                                             bm=best["bm"], bk=best["bk"])
        bsr_dims = (nrb * best["bm"], ncols, len(vb))
        return [make_key("dae_spmv", bsr_dims, "float32",
                         backend_tag(device), wallclock_tag(contenders))]

    def row_bound() -> float:
        # the SpMV tolerance's scale: the largest row sum of |val * vec|
        return float(spmv_ref(_on(rows, device), _on(cols, device),
                              _on(np.abs(val), device), vec.abs()).max())

    measure = _timed(run, ref, reps, contenders, device)
    measure.alias_keys, measure.row_bound = alias_keys, row_bound
    return measure


_KERNEL_MEASURES = {
    "dae_gather": _gather_measure,
    "dae_merge": _merge_measure,
    "flash_attention": _flash_measure,
    "flash_decode": _flash_decode_measure,
    "flash_decode_paged": _flash_decode_paged_measure,
    "grouped_matmul": _gmm_measure,
    "batched_searchsorted": _searchsorted_measure,
    "hash_lookup": _hash_measure,
    "dae_spmv": _spmv_measure,
}


def kernel_key(op: str, dims: Optional[Tuple[int, ...]] = None, *,
               device=None, contenders: int = 1):
    """``(key, dims)``: the cache key a winner of kernel ``op`` at
    ``dims`` (default :data:`KERNEL_DIMS`) measured on ``device`` is
    stored under, without building the runner's inputs."""
    if op not in _KERNEL_MEASURES:
        raise KeyError(f"no kernel runner for {op!r}")
    if contenders < 1:
        raise ValueError(f"contenders must be >= 1, got {contenders}")
    dims = tuple(dims or KERNEL_DIMS[op])
    return make_key(op, dims, KERNEL_DTYPES[op], backend_tag(device),
                    wallclock_tag(contenders)), dims


def kernel_runner(op: str, dims: Optional[Tuple[int, ...]] = None, *,
                  device=None, reps: int = 2, contenders: int = 1):
    """Wall-clock measurement for kernel ``op`` on ``device`` (``None``:
    the card; ``"cpu"``: the plain versions, plumbing only).

    Returns ``(measure, key, dims)`` where ``key`` is the cache key the
    winner should be stored under.  ``contenders > 1`` scores each
    config by the makespan of N concurrent dispatches and keys the
    winner under the per-N ``wallclock:contenders=N`` tag.
    """
    dev = resolve_device(device)
    key, dims = kernel_key(op, dims, device=dev, contenders=contenders)
    measure = _KERNEL_MEASURES[op](dims, dev, reps, contenders)
    return measure, key, dims


def compiled_runner(target: str, *, scale: str = "small", device=None,
                    reps: int = 2):
    """Wall-clock measurement for a `repro_torch.compile` target program.

    The cache key is the *per-program* key from ``program_key_parts``
    (``compiled:<program name>`` + total requests × max port width), the
    same key ``infer_plans`` consults — so a winner persisted here
    dispatches automatically on the next plain ``compile_program`` call.

    The program is elaborated and checked once per runner (the passes
    that do not depend on the knobs); each point re-runs infer and
    codegen with chunk/rif explicit, which is what ``compile_program``
    would build at those knobs.  ``measure.compiled(cfg)`` returns that
    kernel.
    """
    from repro_torch.compile import (check, codegen, elaborate, infer_plans,
                                     program_key_parts)
    from repro_torch.compile.targets import build_target

    dev = resolve_device(device)
    t = build_target(target, scale)
    ir = elaborate(t.prog, t.memories)
    chk = check(t.prog, ir, chase=t.chase)
    op, dims, dtype = program_key_parts(ir)
    key = make_key(op, dims, dtype, backend_tag(dev), "wallclock")

    def compiled(cfg: Config):
        # chunk/rif explicit: never consult the cache mid-search
        plans = infer_plans(ir, chunk=cfg.get("chunk", 64),
                            rif=cfg.get("rif", 8), device=dev)
        return codegen(ir, chk, plans, chase=t.chase, device=dev)

    def measure(cfg: Config) -> float:
        return time_callable(compiled(cfg), reps, device=dev)

    measure.compiled = compiled
    return measure, key, dims


# ---------------------------------------------------------------------------
# Simulator-backed workload runner
# ---------------------------------------------------------------------------


def workload_runner(benchmark: str, config: str = "rhls_dec", *,
                    scale: str = "small", mem: str = "fixed",
                    latency: int = 100, engine: str = "event"):
    """Cycle-count measurement of one (benchmark, config) simulator cell.

    ``measure`` returns simulated cycles; an incorrect result is scored
    ``inf`` and simulator deadlocks propagate (the searcher penalizes
    them), so capacity settings that violate §5.3 are rejected, not
    crashed on.

    ``engine`` picks the scheduler implementation; the default event
    engine is bit-exact with the legacy polling oracle, so cached scores
    stay valid across the engines and the key is only tagged for
    non-default choices.
    """
    from repro_torch.core.workloads import run_workload

    def measure(cfg: Config) -> float:
        rep = run_workload(benchmark, config, scale=scale, mem=mem,
                           latency=latency, rif=cfg["rif"],
                           cap_slack=cfg.get("cap_slack"), engine=engine)
        if not rep.correct:
            return math.inf
        return float(rep.cycles)

    tag = f"sim:{mem}:lat={latency}:scale={scale}"
    if engine != "event":
        tag += f":eng={engine}"
    key = make_key(f"workload:{benchmark}:{config}", (), "int", SIM_BACKEND,
                   tag)
    return measure, key


def multi_workload_runner(benchmark: str, config: str = "rhls_dec", *,
                          n_instances: int = 4, scale: str = "small",
                          mem: str = "fixed", latency: int = 100,
                          max_outstanding: Optional[int] = 64,
                          engine: str = "event"):
    """Contention-aware cycle measurement: score a config by the makespan
    of ``n_instances`` tenants sharing one memory system.

    The single-tenant optimum is often too aggressive under sharing —
    a RIF sized to cover the full latency from one tenant over-subscribes
    the shared outstanding-request budget once N tenants each carry it —
    so knobs tuned here reflect the §5.4 contention regime directly.
    Incorrect results score ``inf``; deadlocks propagate to the searcher's
    deadlock penalty exactly as in :func:`workload_runner`.
    """
    from repro_torch.core.workloads import run_workload_multi

    def measure(cfg: Config) -> float:
        rep = run_workload_multi(benchmark, config, n_instances,
                                 scale=scale, mem=mem, latency=latency,
                                 rif=cfg["rif"],
                                 max_outstanding=max_outstanding,
                                 cap_slack=cfg.get("cap_slack"),
                                 engine=engine)
        if not rep.correct:
            return math.inf
        return float(rep.cycles)

    tag = (f"sim:{mem}:lat={latency}:scale={scale}"
           f":shared_mo={max_outstanding}")
    if engine != "event":
        tag += f":eng={engine}"
    key = make_key(f"workload:{benchmark}:{config}", (n_instances,), "int",
                   SIM_BACKEND, tag)
    return measure, key
