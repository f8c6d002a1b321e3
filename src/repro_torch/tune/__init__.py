"""repro_torch.tune — empirical autotuning of decoupling parameters: the
port of ``repro.tune``.

The paper picks requests-in-flight analytically (latency×bandwidth,
§4.2) and channel capacities by profiling (§5.3/§5.4).  This subsystem
keeps the analytic result (`repro_torch.core.pipeline.plan_rif`) as the
*seed* of a measured search:

    space.py    discrete per-kernel / per-workload search spaces
    search.py   deterministic grid / hill-climb searchers
    runners.py  measurement backends (kernel wall-clock by CUDA events,
                simulator cycles)
    cache.py    persistent JSON cache of winners

Public API
----------

``tune_kernel(op)`` / ``tune_compiled(target)`` / ``tune_workload(bench,
cfg)`` run a search and persist the winner; ``dispatch_config(op, dims,
dtype, device)`` (defined beside the dispatchers in
``repro_torch.kernels.common``) is the cheap cache-only lookup the kernel
dispatchers in ``src/repro_torch/kernels/*/ops.py`` and the compiler's
infer pass call on every invocation — a hit returns the tuned config, a
miss returns ``{}`` and the dispatcher falls back to its analytic
default.

The wall-clock entry points run on the card unless the caller passes
``device="cpu"``, which times the kernels' plain versions: plumbing
only.  Point ``$REPRO_TUNE_CACHE`` at a file of its own to isolate a run.
"""

from __future__ import annotations

import importlib
from typing import Optional, Tuple

from repro_torch.tune.cache import (CacheEntry, Config, TuneCache,
                                    cache_path, default_cache, make_key,
                                    reset_default_cache)

__all__ = [
    "CacheEntry", "TuneCache", "TuneResult", "SearchSpace", "Config",
    "cache_path", "default_cache", "reset_default_cache", "make_key",
    "kernel_space", "workload_space", "compiled_space",
    "kernel_runner", "kernel_key", "compiled_runner", "workload_runner",
    "multi_workload_runner", "KERNEL_DIMS", "KERNEL_DTYPES", "backend_tag",
    "wallclock_tag", "tune_kernel", "tune_workload", "tune_compiled",
    "dispatch_config",
]

# Every kernel dispatcher reads the cache (``kernels.common`` imports
# ``tune.cache``), while the spaces, the searcher and the runners import
# the kernels: they load on first use, so importing a kernel imports
# only the cache.
_LAZY = {name: module for module, names in (
    ("repro_torch.tune.runners", (
        "KERNEL_DIMS", "KERNEL_DTYPES", "backend_tag", "compiled_runner",
        "kernel_key", "kernel_runner", "multi_workload_runner",
        "wallclock_tag", "workload_runner")),
    ("repro_torch.tune.search", ("TuneResult", "search")),
    ("repro_torch.tune.space", ("SearchSpace", "compiled_space",
                                "kernel_space", "workload_space")),
    ("repro_torch.kernels.common", ("dispatch_config",)),
) for name in names}


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def _hit(name: str, hit: CacheEntry) -> TuneResult:
    """A cache hit as a zero-eval :class:`TuneResult`."""
    from repro_torch.tune.search import TuneResult
    return TuneResult(name, dict(hit.config), hit.score, dict(hit.config),
                      hit.baseline_score or hit.score, 0, [])


def tune_kernel(op: str, dims: Optional[Tuple[int, ...]] = None, *,
                device=None, reps: int = 2, max_evals: int = 24,
                strategy: str = "auto", contenders: int = 1,
                cache: Optional[TuneCache] = None,
                force: bool = False) -> TuneResult:
    """Tune kernel ``op`` at ``dims`` by wall-clock and persist the winner.

    A prior winner in the cache short-circuits the search (returned as a
    zero-eval :class:`TuneResult`, before any input is built) unless
    ``force``.

    ``contenders > 1`` tunes for the §5.4 shared-memory contention
    regime: each config is scored by the makespan of N concurrent
    dispatches of the kernel (N CUDA streams), and the winner persists
    under a distinct per-N key (``wallclock:contenders=N``) so
    contention-aware winners never shadow the solo ones — the wall-clock
    mirror of ``tune_workload(instances=N)``.
    """
    from repro_torch.tune.runners import (kernel_key, kernel_runner,
                                          wallclock_tag)
    from repro_torch.tune.search import search
    from repro_torch.tune.space import kernel_space
    cache = cache or default_cache()
    key, dims = kernel_key(op, dims, device=device, contenders=contenders)
    if not force:
        hit = cache.get(key)
        if hit is not None:
            return _hit(op, hit)
    measure, key, dims = kernel_runner(op, dims, device=device, reps=reps,
                                       contenders=contenders)
    space = kernel_space(op, *dims)
    res = search(space, measure, max_evals=max_evals, strategy=strategy)
    entry = CacheEntry(config=res.best, score=res.best_score,
                       baseline_score=res.seed_score,
                       evals=res.evals, note=wallclock_tag(contenders))
    cache.put(key, entry)
    # some ops dispatch under transformed dims (dae_spmv's rif lookup
    # sees BSR operands while the winner is stored at CSR dims); the
    # runner declares those alias keys so the winner is visible at every
    # dispatch site
    alias = getattr(measure, "alias_keys", None)
    if alias is not None:
        for akey in alias(res.best):
            cache.put(akey, CacheEntry(config=res.best,
                                       score=res.best_score,
                                       baseline_score=res.seed_score,
                                       evals=res.evals,
                                       note=wallclock_tag(contenders)
                                       + "-alias"))
    return res


def tune_compiled(target: str, *, scale: str = "small", device=None,
                  reps: int = 2, max_evals: int = 16, strategy: str = "auto",
                  cache: Optional[TuneCache] = None,
                  force: bool = False) -> TuneResult:
    """Tune chunk/RIF for a `repro_torch.compile` target by wall-clock.

    The winner persists under the per-program ``compiled:<target>`` key,
    which is exactly what the compiler's infer pass consults — after
    this runs, a plain ``compile_program`` on the same program for the
    same device picks the tuned ring sizing from the cache with no
    caller involvement.
    """
    from repro_torch.tune.runners import compiled_runner
    from repro_torch.tune.search import search
    from repro_torch.tune.space import compiled_space
    cache = cache or default_cache()
    measure, key, dims = compiled_runner(target, scale=scale, device=device,
                                         reps=reps)
    if not force:
        hit = cache.get(key)
        if hit is not None:
            return _hit(f"compiled:{target}", hit)
    space = compiled_space(dims[0], dims[1], name=f"compiled:{target}")
    res = search(space, measure, max_evals=max_evals, strategy=strategy)
    cache.put(key, CacheEntry(config=res.best, score=res.best_score,
                              baseline_score=res.seed_score,
                              evals=res.evals, note="wallclock"))
    return res


def tune_workload(benchmark: str, config: str = "rhls_dec", *,
                  scale: str = "small", mem: str = "fixed",
                  latency: int = 100, max_evals: int = 32,
                  strategy: str = "auto", instances: int = 1,
                  cache: Optional[TuneCache] = None,
                  force: bool = False) -> TuneResult:
    """Tune (rif, cap_slack) for a simulated DAE workload by cycle count.

    ``instances > 1`` tunes for the multi-tenant contention regime: the
    score is the makespan of N instances sharing one memory system
    (:func:`repro_torch.tune.runners.multi_workload_runner`), cached
    under a distinct per-N key so contention-aware winners never shadow
    the single-tenant ones.
    """
    if instances < 1:
        raise ValueError(f"instances must be >= 1, got {instances}")
    from repro_torch.tune.runners import (multi_workload_runner,
                                          workload_runner)
    from repro_torch.tune.search import search
    from repro_torch.tune.space import workload_space
    cache = cache or default_cache()
    if instances > 1:
        measure, key = multi_workload_runner(benchmark, config,
                                             n_instances=instances,
                                             scale=scale, mem=mem,
                                             latency=latency)
    else:
        measure, key = workload_runner(benchmark, config, scale=scale,
                                       mem=mem, latency=latency)
    if not force:
        hit = cache.get(key)
        if hit is not None:
            return _hit(f"workload:{benchmark}", hit)
    space = workload_space(benchmark, latency=latency)
    res = search(space, measure, max_evals=max_evals, strategy=strategy)
    cache.put(key, CacheEntry(config=res.best, score=res.best_score,
                              baseline_score=res.seed_score,
                              evals=res.evals,
                              note=f"sim:{mem}:lat={latency}"))
    return res
