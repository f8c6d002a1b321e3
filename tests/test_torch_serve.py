"""Parity of the port's serve loops with the JAX package's, on the CPU.

The JAX serve bench's paged-parity cell (``benchmarks/serve_bench.py::
paged_parity``: prompts of 12, 3, 25, 7, 1 and 18 tokens, 8 new tokens
each, 4 slots, s_max 40, chunk 16, page 8) and its prefix-reuse cell run
through both packages with the same weights: token streams and
structural counters must be exactly equal.  Then the page allocator,
prefix cache, preemption, copy-on-write and validation units of
``tests/test_paged_serve.py``, against the port.
"""

import time

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.trace import Tracer as JaxTracer
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serve_loop import PagedServeLoop as JaxPagedServeLoop
from repro.runtime.serve_loop import Request as JaxRequest
from repro.runtime.serve_loop import ServeLoop as JaxServeLoop
from repro_torch.bench import percentile, percentiles
from repro_torch.configs import get_config
from repro_torch.core.trace import Tracer
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve_loop import (PageAllocator, PagedServeLoop,
                                            PrefixCache, Request, ServeLoop)

CHUNK, PAGE = 16, 8
_CACHE = {}


def _jax():
    if "jax" not in _CACHE:
        cfg = jax_get_config("qwen3-4b", smoke=True)
        bundle = jax_build_model(cfg)
        params = bundle.init(jax.random.PRNGKey(0))
        _CACHE["jax"] = (cfg, bundle, params,
                         jax.tree.map(np.asarray, params))
    return _CACHE["jax"]


def _port(mode="kernel"):
    if mode not in _CACHE:
        cfg = get_config("qwen3-4b", smoke=True, kernel_mode=mode)
        _CACHE[mode] = (cfg, build_model(cfg, device="cpu"),
                        params_from_numpy(cfg, _jax()[3], device="cpu"))
    return _CACHE[mode]


def _prompt(n, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=n)


def _parity_prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n) for n in (12, 3, 25, 7, 1, 18)]


def _jax_parity_streams():
    if "parity" not in _CACHE:
        cfg, bundle, params, _ = _jax()
        prompts = _parity_prompts(cfg.vocab)
        out = {}
        for name, cls, kw in (("contig", JaxServeLoop, {}),
                              ("paged", JaxPagedServeLoop, {"page": PAGE})):
            tracer = JaxTracer()
            loop = cls(cfg, bundle, params, batch_slots=4, s_max=40,
                       chunk=CHUNK, tracer=tracer, **kw)
            out[name] = loop.run([JaxRequest(rid=i, prompt=p, max_new=8)
                                  for i, p in enumerate(prompts)])
            out[name + "_allocs"] = loop.stats.page_allocs
            out[name + "_occ"] = tracer.summary().channel_occupancy()
        _CACHE["parity"] = out
    return _CACHE["parity"]


# -- serve-bench cells against JAX --------------------------------------------


@pytest.mark.parametrize("mode", ["kernel", "ref"])
def test_paged_parity_cell_matches_jax(mode):
    want = _jax_parity_streams()
    cfg, bundle, params = _port(mode)
    prompts = _parity_prompts(cfg.vocab)

    def reqs():
        return [Request(rid=i, prompt=p, max_new=8)
                for i, p in enumerate(prompts)]

    tracers = Tracer(), Tracer()
    contig = ServeLoop(cfg, bundle, params, batch_slots=4, s_max=40,
                       chunk=CHUNK, tracer=tracers[0])
    r_c = contig.run(reqs())
    paged = PagedServeLoop(cfg, bundle, params, batch_slots=4, s_max=40,
                           chunk=CHUNK, page=PAGE, tracer=tracers[1])
    r_p = paged.run(reqs())
    assert r_c == want["contig"]
    assert r_p == want["paged"] == r_c
    assert tracers[0].summary().channel_occupancy() == want["contig_occ"]
    assert tracers[1].summary().channel_occupancy() == want["paged_occ"]
    assert sum(len(v) for v in r_c.values()) == 48
    assert paged.stats.page_allocs == want["paged_allocs"] == 16


def test_prefix_reuse_cell_matches_jax():
    jcfg, jbundle, jparams, _ = _jax()
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab,
                                               size=3 * PAGE + 2)

    def cell(loop, req_cls):
        cold = loop.run([req_cls(rid=0, prompt=prompt, max_new=8)])
        allocs_cold = loop.stats.page_allocs
        warm = loop.run([req_cls(rid=1, prompt=prompt, max_new=8)])
        return (cold[0], warm[1], allocs_cold,
                loop.stats.page_allocs - allocs_cold, loop.stats.prefix_hits,
                loop.stats.prefix_tokens_reused)

    want = cell(JaxPagedServeLoop(jcfg, jbundle, jparams, batch_slots=2,
                                  s_max=64, chunk=CHUNK, page=PAGE),
                JaxRequest)
    cfg, bundle, params = _port()
    got = cell(PagedServeLoop(cfg, bundle, params, batch_slots=2, s_max=64,
                              chunk=CHUNK, page=PAGE), Request)
    assert got == want
    assert got[0] == got[1]
    assert got[2:] == (5, 2, 1, 24)


# -- allocator / prefix cache / percentile units ------------------------------


def test_page_allocator_basics():
    a = PageAllocator(n_pages=4, page=8)
    assert a.free_count == 3            # page 0 is the pinned trash page
    p1, p2, p3 = a.alloc(), a.alloc(), a.alloc()
    assert sorted([p1, p2, p3]) == [1, 2, 3]
    assert a.alloc() is None            # exhausted, never raises
    a.incref(p2)
    a.decref(p2)
    assert a.free_count == 0            # still referenced by the incref
    a.decref(p2)
    assert a.free_count == 1 and a.alloc() == p2
    with pytest.raises(ValueError):
        PageAllocator(n_pages=1, page=8)


def test_prefix_cache_lookup_register_evict():
    alloc = PageAllocator(n_pages=8, page=4)
    pages = [alloc.alloc(), alloc.alloc()]
    fill = np.arange(8)
    cache = PrefixCache()
    assert cache.register(fill, 4, pages[:1], alloc)
    assert cache.register(fill, 8, pages, alloc)
    assert not cache.register(fill, 8, pages, alloc)     # already there
    assert alloc.rc[pages[0]] == 3
    # the longest registered prefix within the cap wins, increfs pages
    assert cache.lookup(np.arange(10), 9, alloc) == (8, pages)
    assert cache.lookup(np.arange(10), 7, alloc) == (4, pages[:1])
    assert cache.lookup(np.array([9, 9, 9, 9]), 4, alloc) == (0, [])
    assert alloc.rc[pages[0]] == 5
    assert cache.evict_lru(alloc) and cache.evict_lru(alloc)
    assert not cache.evict_lru(alloc) and len(cache) == 0
    assert alloc.rc[pages[0]] == 3


def test_percentile_linear_interpolation():
    xs = list(range(1, 11))
    assert percentile(xs, 0) == 1 and percentile(xs, 100) == 10
    assert percentile(xs, 50) == 5.5
    assert percentile(xs, 95) == pytest.approx(9.55)
    assert percentile([7.0], 99) == 7.0
    assert set(percentiles(xs)) == {"p50", "p95", "p99"}
    with pytest.raises(ValueError):
        percentile([], 50)
    with pytest.raises(ValueError):
        percentile(xs, 101)


# -- page pressure, prefix reuse, copy-on-write --------------------------------


def test_page_exhaustion_preempts_and_completes():
    cfg, m, params = _port()
    reqs = lambda: [Request(rid=0, prompt=_prompt(10, cfg.vocab, seed=1),
                            max_new=6),
                    Request(rid=1, prompt=_prompt(6, cfg.vocab, seed=2),
                            max_new=6)]
    roomy = PagedServeLoop(cfg, m, params, batch_slots=2, s_max=16, page=4,
                           prefix_reuse=False)
    ref = roomy.run(reqs())
    assert roomy.stats.preemptions == 0
    tight = PagedServeLoop(cfg, m, params, batch_slots=2, s_max=16, page=4,
                           n_pages=6, prefix_reuse=False)
    assert tight.run(reqs()) == ref      # resume is teacher-forced exact
    assert tight.stats.preemptions >= 1


def test_min_pool_serial_completion():
    cfg, m, params = _port()
    loop = PagedServeLoop(cfg, m, params, batch_slots=2, s_max=16, page=4,
                          n_pages=5, prefix_reuse=False)
    results = loop.run([Request(rid=i, prompt=_prompt(8, cfg.vocab, seed=i),
                                max_new=6) for i in range(3)])
    assert set(results) == {0, 1, 2}
    assert all(len(v) == 6 for v in results.values())


def test_pool_too_small_rejected():
    cfg, m, params = _port()
    with pytest.raises(ValueError, match="page"):
        PagedServeLoop(cfg, m, params, batch_slots=1, s_max=16, page=4,
                       n_pages=4)


def test_cow_on_divergence_inside_shared_page():
    cfg, m, params = _port()
    base = _prompt(18, cfg.vocab, seed=5)
    ext_b = np.concatenate([base, [7, 3]])
    ext_c = np.concatenate([base, [9]])
    loop = PagedServeLoop(cfg, m, params, batch_slots=2, s_max=32, page=8)
    out_a = loop.run([Request(rid=0, prompt=base, max_new=4)])[0]
    res = loop.run([Request(rid=1, prompt=ext_b, max_new=4),
                    Request(rid=2, prompt=ext_c, max_new=4)])
    assert loop.stats.cow_copies >= 2 and loop.stats.prefix_hits >= 2
    for rid, prompt in ((1, ext_b), (2, ext_c)):
        solo = PagedServeLoop(cfg, m, params, batch_slots=1, s_max=32,
                              page=8, prefix_reuse=False)
        assert res[rid] == solo.run([Request(rid=0, prompt=prompt,
                                             max_new=4)])[0], rid
    assert loop.run([Request(rid=3, prompt=base, max_new=4)])[3] == out_a


def test_page_stats_and_trace():
    cfg, m, params = _port()
    tracer = Tracer()
    loop = PagedServeLoop(cfg, m, params, batch_slots=2, s_max=32, page=8,
                          tracer=tracer)
    loop.run([Request(rid=0, prompt=_prompt(12, cfg.vocab, seed=6),
                      max_new=4)])
    st = loop.page_stats()
    assert st["capacity_tokens"] == st["pages_used"] * 8
    assert st["pages_used"] + st["pages_free"] == loop.alloc.n_pages - 1
    assert 0.0 <= st["fragmentation"] <= 1.0
    occ = tracer.summary().channel_occupancy()
    assert set(occ) == {"serve/admit", "serve/prefill_done",
                        "serve/free_slots"}


def test_open_loop_arrivals_match_closed_loop():
    cfg, m, params = _port()
    prompts = [_prompt(4 + i, cfg.vocab, seed=i) for i in range(4)]
    ref = PagedServeLoop(cfg, m, params, batch_slots=2, s_max=32,
                         page=8).run([Request(rid=i, prompt=p, max_new=4)
                                      for i, p in enumerate(prompts)])
    opened = PagedServeLoop(cfg, m, params, batch_slots=2, s_max=32, page=8)
    t0 = time.perf_counter()
    res = opened.run([Request(rid=i, prompt=p, max_new=4, t_arrival=0.01 * i)
                      for i, p in enumerate(prompts)])
    assert time.perf_counter() - t0 >= 0.03
    assert res == ref
    assert set(opened.stats.ttft) == {0, 1, 2, 3}
    assert all(t >= 0.0 for t in opened.stats.ttft.values())


# -- validation both loops share ----------------------------------------------


@pytest.mark.parametrize("cls", [ServeLoop, PagedServeLoop])
def test_duplicate_rid_rejected(cls):
    cfg, m, params = _port()
    loop = cls(cfg, m, params, batch_slots=1, s_max=32)
    with pytest.raises(ValueError, match="duplicate"):
        loop.run([Request(rid=5, prompt=_prompt(3, cfg.vocab), max_new=2),
                  Request(rid=5, prompt=_prompt(4, cfg.vocab), max_new=2)])


@pytest.mark.parametrize("cls", [ServeLoop, PagedServeLoop])
def test_oversize_request_rejected(cls):
    cfg, m, params = _port()
    loop = cls(cfg, m, params, batch_slots=1, s_max=16)
    with pytest.raises(ValueError, match="s_max"):
        loop.run([Request(rid=0, prompt=_prompt(12, cfg.vocab), max_new=8)])


def test_empty_prompt_and_zero_max_new():
    cfg, m, params = _port()
    loop = ServeLoop(cfg, m, params, batch_slots=2, s_max=16)
    res = loop.run([Request(rid=0, prompt=np.array([], np.int64), max_new=3),
                    Request(rid=1, prompt=_prompt(3, cfg.vocab), max_new=0)])
    assert len(res[0]) == 3 and res[1] == []
