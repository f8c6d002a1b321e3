"""Search spaces for the decoupling parameters (paper §4.2, §5.3/§5.4):
the port's copy of ``repro.tune.space``.

A :class:`SearchSpace` is an ordered mapping from parameter name to the
discrete values the tuner may try.  Every space ships with a *seed
configuration*, so the empirical search starts from the paper's
latency×bandwidth heuristic and only has to correct it, not rediscover
it.

Knob names and grids are the reference's wherever the Hopper kernel has
the knob, cut to what the kernel can run or tell apart:

* ring depths stop at ``MAX_RIF`` (16, the deepest ``csrc/ring.cuh``
  waits on); the merge's at ``MAX_STAGES`` (4); the block search's at
  ``SEARCH_MAX_KPT`` (4 keys a lane group, what a larger ``rif`` gives);
  the split-KV decodes' at the multiples of ``PAGED_WARPS`` (their
  ``rif`` is blocks in flight per CTA, ``rif // 4`` stages a warp);
* the decode block ``bk`` takes the port's default 16 beside the
  reference's sizes, up to the largest whose four warps' K and V stage
  fits an sm_90 block's shared memory with 32 KiB to spare;
* ``grouped_matmul``'s ``bf`` is the kernel's column tile, 128 or 256.

The decodes are keyed as the reference keys them, on (S, D) and (page,
D), but measured at one batch: 8 slots of 8 KV heads with G 4 query rows
a KV head (qwen3-4b's decode, ``runners._flash_decode_measure``).  A
winner then dispatches on every decode at that S (or page) and D, at any
batch and G (granite-34b's G 48 and a single request too).  Its ``rif``
cannot change the occupancy there: the wrapper clamps any ``rif`` to the
ring that keeps four CTAs on an SM (``kernel._paged_depth``), so a rif
past what fits that share runs the deepest ring that does.

A reference knob with no Hopper counterpart is left out: ``dae_gather``'s
``block_d``, ``flash_attention``'s ``bq``/``bk`` (the port tunes the
prefill's K/V ring depth ``rif`` instead), ``grouped_matmul``'s ``bd``
and ``hash_lookup``'s ``rif`` (every chain of a CTA has its load in
flight).

Seeds are the port's own analytic defaults, so they may differ from the
reference's: :func:`~repro_torch.core.pipeline.plan_rif` over the H100's
latency × bandwidth and half the sm_90 shared-memory opt-in, sized on
what the Hopper kernel streams, or the wrapper's measured default where
it has one (the merge's ``DEFAULT_STAGES``, the decodes' depth, the
decode block ``DEFAULT_BK``, the column tile ``DEFAULT_BN``); then
snapped to the grid.  The spaces of the kernels that run bfloat16 on the
serve path (attention and ``grouped_matmul``) are sized for bfloat16.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Iterator, Mapping, Tuple

from repro_torch.core.pipeline import SMEM_OPTIN_BYTES, plan_rif
from repro_torch.kernels.dae_chase.kernel import SEARCH_MAX_KPT
from repro_torch.kernels.dae_merge.kernel import DEFAULT_STAGES, MAX_STAGES
from repro_torch.kernels.flash_attention.kernel import (DEFAULT_BK,
                                                        PAGED_CTAS_PER_SM,
                                                        PAGED_WARPS)
from repro_torch.kernels.grouped_matmul.kernel import DEFAULT_BN, STAGE_DEPTH
from repro_torch.kernels.ring import MAX_RIF

Config = Dict[str, Any]

__all__ = ["SearchSpace", "Config", "kernel_space", "workload_space",
           "compiled_space", "KERNEL_SPACES"]


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Ordered discrete search space with a seed point.

    ``params`` maps name -> tuple of allowed values (each tuple sorted in
    the natural "increasing resource" order so the hill-climber's ±1-step
    neighbourhood is meaningful).  ``seed`` must use only listed values —
    :meth:`snap` projects an arbitrary config onto the grid.
    """

    name: str
    params: Mapping[str, Tuple[Any, ...]]
    seed: Config

    def __post_init__(self) -> None:
        for k, vs in self.params.items():
            if not vs:
                raise ValueError(f"space {self.name}: param {k!r} is empty")

    @property
    def size(self) -> int:
        n = 1
        for vs in self.params.values():
            n *= len(vs)
        return n

    def snap(self, cfg: Config) -> Config:
        """Project ``cfg`` onto the grid (nearest listed value per param;
        unknown params dropped, missing params filled from the seed)."""
        out: Config = {}
        for k, vs in self.params.items():
            want = cfg.get(k, self.seed.get(k, vs[0]))
            if want in vs:
                out[k] = want
            elif all(isinstance(v, (int, float)) for v in vs) and isinstance(
                    want, (int, float)):
                out[k] = min(vs, key=lambda v: abs(v - want))
            else:
                out[k] = vs[0]
        return out

    def neighbours(self, cfg: Config) -> Iterator[Config]:
        """±1 grid step along each axis (the hill-climb neighbourhood)."""
        for k, vs in self.params.items():
            i = vs.index(cfg[k])
            for j in (i - 1, i + 1):
                if 0 <= j < len(vs):
                    yield {**cfg, k: vs[j]}

    def grid(self) -> Iterator[Config]:
        keys = list(self.params)
        for combo in itertools.product(*(self.params[k] for k in keys)):
            yield dict(zip(keys, combo))


# ---------------------------------------------------------------------------
# Kernel spaces (wall-clock backend)
# ---------------------------------------------------------------------------


def _pow2_range(lo: int, hi: int) -> Tuple[int, ...]:
    out = []
    v = lo
    while v <= hi:
        out.append(v)
        v *= 2
    return tuple(out)


def _snapped(sp: SearchSpace) -> SearchSpace:
    return dataclasses.replace(sp, seed=sp.snap(sp.seed))


_RIFS = _pow2_range(1, MAX_RIF)
# the split-KV decodes' rif: blocks in flight per CTA, PAGED_WARPS a stage
_DECODE_RIFS = _pow2_range(PAGED_WARPS, MAX_RIF)
_DECODE_SPARE = 32 << 10     # shared memory beside the K/V ring (Q, merge)


def _gather_space(n: int, d: int, m: int, itemsize: int = 4) -> SearchSpace:
    """Decoupled gather: dispatch method plus the explicit ring's knobs.

    ``method`` is part of the space — 'pipelined' (``gather_rows``) vs
    'rif' (``gather_rif``, an explicit ring of ``rif`` row copies over
    ``chunk`` rows a CTA).  ``chunk``/``rif`` only act under 'rif'; the
    space is small enough that the redundant cross-terms cost a handful
    of evals.
    """
    chunks = tuple(c for c in _pow2_range(16, 256) if c <= max(16, m))
    rifs = _pow2_range(2, MAX_RIF)
    chunk0 = chunks[min(len(chunks) - 1, 2)]
    # analytic seed: one chunk of rows is the ring's request, as the
    # dispatcher sizes it
    plan = plan_rif(chunk0 * max(d, 1) * itemsize)
    seed = {"method": "pipelined", "chunk": chunk0,
            "rif": min(plan.rif, chunk0)}
    return _snapped(SearchSpace("dae_gather", {
        "method": ("pipelined", "rif"),
        "chunk": chunks,
        "rif": rifs,
    }, seed))


def _merge_space(n: int, m: int) -> SearchSpace:
    tiles = tuple(t for t in _pow2_range(64, 1024) if t <= max(64, n + m))
    return _snapped(SearchSpace("dae_merge", {
        "tile": tiles,
        "rif": _pow2_range(1, MAX_STAGES),
    }, {"tile": 256, "rif": DEFAULT_STAGES}))


def _flash_space(sq: int, sk: int, d: int, itemsize: int = 2) -> SearchSpace:
    """Prefill attention: the K/V ring's stages.  The seed plans over one
    stage, a K and a V block of the default keys (128 up to D 128, 64
    above), as ``csrc/flash_prefill.cu`` sizes it."""
    keys = 128 if d <= 128 else 64
    plan = plan_rif(2 * keys * max(d, 1) * itemsize)
    return _snapped(SearchSpace("flash_attention", {"rif": _RIFS},
                                {"rif": plan.rif}))


def _decode_rif(block: int, d: int, itemsize: int) -> int:
    """The split-KV decodes' default ``rif``: ``PAGED_WARPS`` times the
    deepest of at most two K+V stages a warp that keeps
    ``PAGED_CTAS_PER_SM`` CTAs on an SM's shared memory."""
    stage = PAGED_WARPS * 2 * block * max(d, 1) * itemsize
    depth = 2 if 2 * stage <= SMEM_OPTIN_BYTES // PAGED_CTAS_PER_SM else 1
    return PAGED_WARPS * depth


def _flash_decode_space(s: int, d: int, itemsize: int = 2) -> SearchSpace:
    """Decode K/V block stream: block size plus blocks in flight."""
    fits = SMEM_OPTIN_BYTES - _DECODE_SPARE
    bks = tuple(b for b in (DEFAULT_BK, 32, 64, 128, 256)
                if b <= max(DEFAULT_BK, s)
                and PAGED_WARPS * 2 * b * max(d, 1) * itemsize <= fits)
    return _snapped(SearchSpace("flash_decode", {
        "bk": bks,
        "rif": _DECODE_RIFS,
    }, {"bk": DEFAULT_BK, "rif": _decode_rif(DEFAULT_BK, d, itemsize)}))


def _flash_decode_paged_space(page: int, d: int,
                              itemsize: int = 2) -> SearchSpace:
    """Paged decode: the page size is fixed by the cache layout, so only
    the blocks in flight are searchable."""
    return _snapped(SearchSpace("flash_decode_paged", {
        "rif": _DECODE_RIFS,
    }, {"rif": _decode_rif(max(page, 1), d, itemsize)}))


def _gmm_space(t: int, d: int, f: int, itemsize: int = 2) -> SearchSpace:
    """Grouped expert matmul: the column tile plus the expert-weight ring
    depth (§4.2's RIF, one (64, bf) weight tile per request)."""
    bfs = tuple(b for b in (128, 256) if b <= max(128, f))
    bf0 = min(DEFAULT_BN, bfs[-1])
    plan = plan_rif(STAGE_DEPTH * bf0 * itemsize)
    return _snapped(SearchSpace("grouped_matmul", {
        "bf": bfs,
        "rif": _RIFS,
    }, {"bf": bf0, "rif": plan.rif}))


def _searchsorted_space(n: int, m: int) -> SearchSpace:
    """Decoupled block search: block size plus the keys-per-CTA chunk
    and the keys each lane group keeps in flight (§4.2's RIF)."""
    blocks = tuple(b for b in (64, 128, 256, 512) if b <= max(64, n))
    chunks = tuple(c for c in _pow2_range(16, 256) if c <= max(16, m))
    plan = plan_rif(128 * 4)
    return _snapped(SearchSpace("batched_searchsorted", {
        "block": blocks,
        "chunk": chunks,
        "rif": _pow2_range(1, SEARCH_MAX_KPT),
    }, {"block": 128, "chunk": 64, "rif": plan.rif}))


def _hash_lookup_space(n: int, m: int) -> SearchSpace:
    """Lock-step chain walk: chains per CTA (the paper's central knob for
    the hashtable benchmark; every chain keeps its load in flight)."""
    chunks = tuple(c for c in _pow2_range(16, 256) if c <= max(16, m))
    return _snapped(SearchSpace("hash_lookup", {"chunk": chunks},
                                {"chunk": 64}))


def _spmv_space(nrows: int, ncols: int, nnz: int) -> SearchSpace:
    """BSR block shape (conversion-time knob consulted by csr_to_bsr)
    plus the stage ring depth of the matvec kernel."""
    plan = plan_rif(128 * 4)
    return _snapped(SearchSpace("dae_spmv", {
        "bm": (8, 16, 32),
        "bk": (128, 256),
        "rif": _RIFS,
    }, {"bm": 8, "bk": 128, "rif": plan.rif}))


def compiled_space(total_requests: int, width: int, itemsize: int = 4,
                   name: str = "compiled") -> SearchSpace:
    """Chunk × ring-depth space for a `repro_torch.compile` program.

    One space per *program* (not per channel): the compiler applies the
    winning chunk/rif to every ring it emits, matching the one-key-per-
    program cache contract of ``program_key_parts``.
    """
    chunks = tuple(c for c in _pow2_range(8, 256)
                   if c <= max(8, total_requests))
    plan = plan_rif(max(width, 1) * itemsize)
    return _snapped(SearchSpace(name, {
        "chunk": chunks,
        "rif": _RIFS,
    }, {"chunk": 64, "rif": plan.rif}))


KERNEL_SPACES = {
    "dae_gather": _gather_space,
    "dae_merge": _merge_space,
    "flash_attention": _flash_space,
    "flash_decode": _flash_decode_space,
    "flash_decode_paged": _flash_decode_paged_space,
    "grouped_matmul": _gmm_space,
    "batched_searchsorted": _searchsorted_space,
    "hash_lookup": _hash_lookup_space,
    "dae_spmv": _spmv_space,
}


def kernel_space(op: str, *dims: int) -> SearchSpace:
    """Search space for kernel ``op`` at the given problem dimensions."""
    try:
        builder = KERNEL_SPACES[op]
    except KeyError:
        raise KeyError(f"no search space registered for kernel {op!r}")
    return builder(*dims)


# ---------------------------------------------------------------------------
# Workload (simulator backend) space
# ---------------------------------------------------------------------------


def workload_space(benchmark: str, latency: int = 100,
                   word_bytes: int = 8) -> SearchSpace:
    """RIF × channel-capacity-slack space for a simulated DAE workload:
    the reference's space, point for point.

    ``cap_slack`` is the channel capacity headroom over the ring depth:
    load/stream channels get ``capacity = rif + cap_slack``.  Negative
    slack (capacity below the ring depth) is the §5.3 danger zone — a
    round-robin chase deadlocks there, which the searcher maps to an
    infinite score via the deadlock penalty; large slack burns buffer
    resources for no speedup (§5.4).
    """
    rifs = _pow2_range(2, 256)
    slacks = (-4, 0, 1, 4, 16, 64)
    # seed: cover `latency` cycles of 1-word/cycle issue (§4.2): feed the
    # planner a 1-second-per-cycle latency and 1-word-per-second bandwidth
    plan = plan_rif(word_bytes, latency_s=float(latency),
                    bandwidth=float(word_bytes), max_rif=rifs[-1])
    seed = {"rif": plan.rif, "cap_slack": 1}
    return _snapped(SearchSpace(f"workload:{benchmark}",
                                {"rif": rifs, "cap_slack": slacks}, seed))
