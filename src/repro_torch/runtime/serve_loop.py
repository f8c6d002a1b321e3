"""Decoupled Access/Execute serving pipeline (paper §3 applied to
serving): the port of ``repro.runtime.serve_loop``.

Serving is two engines joined by explicit bounded channels:

    requests ──admit──▶ [ACCESS: admission + chunked batched prefill]
                 │                    │
                 │              prefill_done (first token rides along)
                 │                    ▼
                 └─◀─free_slots── [EXECUTE: dense batched decode] ──▶ results

Both engines drive one primitive, ``bundle.prefill``: the Access engine
advances every admitting slot by up to ``chunk`` prompt tokens per step,
and the Execute engine calls it at chunk width 1 with a 0/1 per-slot
valid mask (a masked decode step).  The scheduler interleaves them one
step per round.  ``run`` is open-loop: a :class:`Request` is released to
the admit channel once its ``t_arrival`` has passed, and TTFT counts
from that arrival.

:class:`PagedServeLoop` serves the same pipeline from *paged* KV: a pool
of fixed-size pages owned by a refcounted :class:`PageAllocator`, a page
table per slot, hash-keyed prompt-prefix reuse (:class:`PrefixCache`)
with copy-on-write on divergence, and preemption-aware admission (a
request that cannot get pages parks at the head of the admit channel; a
slot that cannot extend preempts the youngest slot, which later resumes
teacher-forced with identical outputs).  In ``kernel`` mode its decode
steps run ``flash_decode_paged`` over the page table.

:class:`LegacyServeLoop` is the coupled loop the pipeline replaced,
kept as the serving baseline: admission feeds each prompt one token at
a time through the full-batch decode step, stalling every active slot
(and polluting its cache) for the whole prompt.

Differences from the JAX loops: the port runs eagerly (no jit
wrappers), host state stays in numpy and moves to the model's device as
tensors each step, and the caches are updated in place.  The
encoder-decoder path is not ported yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.channels import LocalChannel
from repro_torch.core.trace import Tracer
from repro_torch.kernels.common import resolve_device

# slot phases
_FREE, _PREFILL, _HANDOFF, _DECODE = 0, 1, 2, 3


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (P,) int — P may be 0 (treated as [bos])
    max_new: int = 16
    out: Optional[List[int]] = None
    t_arrival: float = 0.0      # seconds after run() start (open-loop traces)


def _validate_requests(requests: List[Request], s_max: int) -> None:
    """Up-front validation: rejecting a request after part of the batch
    was admitted would leave slots mid-flight, and results and stats are
    keyed by rid, so duplicates would silently overwrite."""
    seen = set()
    for req in requests:
        if req.rid in seen:
            raise ValueError(f"duplicate request rid {req.rid}: results "
                             "and stats.ttft are keyed by rid")
        seen.add(req.rid)
        psize = max(1, np.asarray(req.prompt).size)   # empty -> [bos]
        if psize + req.max_new > s_max:
            raise ValueError(
                f"request {req.rid}: prompt ({psize}) + max_new "
                f"({req.max_new}) exceeds s_max ({s_max})")


@dataclasses.dataclass
class ServeStats:
    """Counters of one loop; ttft is wall-clock seconds from each
    request's *arrival* to its first emitted token.  The page counters
    stay 0 on the contiguous path."""

    rounds: int = 0
    prefill_steps: int = 0
    decode_steps: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    admitted: int = 0
    ttft: Dict[int, float] = dataclasses.field(default_factory=dict)
    # paged serving
    page_allocs: int = 0
    cow_copies: int = 0
    preemptions: int = 0
    prefix_hits: int = 0
    prefix_tokens_reused: int = 0
    # peak over rounds of sum(prompt + max_new) across active slots
    peak_reserved_tokens: int = 0


class PageAllocator:
    """Free-list allocator over a pool of fixed-size KV pages.

    Page 0 is the reserved *trash page*: page tables default to it, and
    the paged attention path routes every invalid-token write there —
    it is never attended to because lengths mask it, so the allocator
    pins it (refcount 1) forever.  Pages are refcounted so the prefix
    cache and several adopting slots can share them; ``decref`` returns
    a page to the free list when its last reference drops.
    """

    def __init__(self, n_pages: int, page: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.n_pages = n_pages
        self.page = page
        self.rc = np.zeros(n_pages, np.int32)
        self.rc[0] = 1                       # trash page, permanently pinned
        self.free = deque(range(1, n_pages))

    @property
    def free_count(self) -> int:
        return len(self.free)

    def alloc(self) -> Optional[int]:
        if not self.free:
            return None
        p = self.free.popleft()
        self.rc[p] = 1
        return p

    def incref(self, p: int) -> None:
        self.rc[p] += 1

    def decref(self, p: int) -> None:
        self.rc[p] -= 1
        if self.rc[p] == 0:
            self.free.append(p)


class PrefixCache:
    """Hash-keyed prompt-prefix -> KV-pages map with LRU eviction.

    When a slot finishes prefilling, every page-aligned prefix of its
    fill (plus the final partial length) is registered with a refcount
    on each covering page.  A later request whose fill starts with a
    registered prefix adopts the pages: its page table points at them,
    its cache length starts at the matched length, and prefill resumes
    after it.  Keys are sha1 over the token bytes; entries keep the
    tokens and compare them exactly, so a hash collision never adopts
    wrong KV.
    """

    def __init__(self) -> None:
        # key -> (length, pages tuple, tokens copy)
        self._entries: "OrderedDict[bytes, Tuple[int, Tuple[int, ...], np.ndarray]]" = OrderedDict()
        self._lens: Dict[int, int] = {}       # length -> #entries of that length

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _key(tokens: np.ndarray) -> bytes:
        return hashlib.sha1(
            np.ascontiguousarray(tokens, np.int64).tobytes()).digest()

    def lookup(self, fill: np.ndarray, cap: int, alloc: PageAllocator
               ) -> Tuple[int, List[int]]:
        """Longest registered prefix of ``fill`` with length <= cap.
        On a hit the covering pages are increfed (the caller decrefs if
        it parks instead of admitting)."""
        for ln in sorted(self._lens, reverse=True):
            if ln > cap or ln > fill.size:
                continue
            key = self._key(fill[:ln])
            entry = self._entries.get(key)
            if entry is None or entry[0] != ln:
                continue
            if not np.array_equal(entry[2], fill[:ln]):
                continue                      # sha1 collision: never adopt
            self._entries.move_to_end(key)
            pages = list(entry[1])
            for p in pages:
                alloc.incref(p)
            return ln, pages
        return 0, []

    def register(self, fill: np.ndarray, length: int, pages: List[int],
                 alloc: PageAllocator) -> bool:
        key = self._key(fill[:length])
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        for p in pages:
            alloc.incref(p)
        self._entries[key] = (length, tuple(pages), fill[:length].copy())
        self._lens[length] = self._lens.get(length, 0) + 1
        return True

    def evict_lru(self, alloc: PageAllocator) -> bool:
        if not self._entries:
            return False
        _, (length, pages, _) = self._entries.popitem(last=False)
        self._lens[length] -= 1
        if not self._lens[length]:
            del self._lens[length]
        for p in pages:
            alloc.decref(p)
        return True


class ServeLoop:
    """Continuous batching with decoupled chunked prefill (Access) and
    dense masked decode (Execute) over a contiguous KV cache.

    ``chunk`` is the Access engine's tokens-per-step; ``tracer`` records
    channel occupancy; ``stats`` counts steps, tokens and TTFT.  The loop
    runs on the bundle's device.
    """

    def __init__(self, cfg, bundle, params, batch_slots: int, s_max: int,
                 eos_id: int = -1, chunk: int = 32, bos_id: int = 0,
                 tracer: Optional[Tracer] = None,
                 admit_capacity: Optional[int] = None):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.cfg = cfg
        self.bundle = bundle
        self.params = params
        self.device = bundle.device
        self.b = batch_slots
        self.s_max = s_max
        self.eos = eos_id
        self.chunk = chunk
        self.bos = bos_id
        self.tracer = tracer
        self.pos = np.zeros(batch_slots, np.int32)
        self.cur = np.zeros(batch_slots, np.int32)
        self.remaining = np.zeros(batch_slots, np.int64)
        self.phase = np.full(batch_slots, _FREE, np.int8)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self._ptr = np.zeros(batch_slots, np.int64)     # prefill progress
        self._psize = np.zeros(batch_slots, np.int64)   # original prompt size
        self._prompt: List[Optional[np.ndarray]] = [None] * batch_slots

        self.paged = False
        self._make_cache()

        # explicit bounded channels between the engines
        self.admit_q = LocalChannel("admit", admit_capacity, self.tracer)
        self.handoff = LocalChannel("prefill_done", self.b, self.tracer)
        self.free_slots = LocalChannel("free_slots", self.b, self.tracer)
        for s in range(batch_slots):
            self.free_slots.push(s)
        self._overflow: deque = deque()     # beyond admit_q capacity
        self.stats = ServeStats()

    def _make_cache(self) -> None:
        """Cache + step-function setup; PagedServeLoop overrides."""
        self.cache = self.bundle.cache_init(self.b, self.s_max)
        self._fwd = self.bundle.prefill
        self._reset = self.bundle.cache_reset

    def _dev(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    # -- shared step dispatch ------------------------------------------------

    def _step(self, tok: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
        args = (self._dev(tok), self._dev(self.pos), self._dev(n_valid))
        if self.paged:
            args = args + (self._dev(self.table),)
        with torch.inference_mode():
            logits, self.cache = self._fwd(self.params, self.cache, *args)
        return logits.cpu().numpy()

    # -- Access engine: admission + chunked prefill --------------------------

    def _admit(self) -> None:
        reset: List[int] = []
        while self.free_slots and self.admit_q:
            slot = self.free_slots.pop()
            req = self.admit_q.pop()
            prompt = np.asarray(req.prompt, np.int64).reshape(-1)
            if prompt.size == 0:
                # empty prompt: generate from an implicit BOS token
                prompt = np.array([self.bos], np.int64)
            req.out = []
            self.active[slot] = req
            self._prompt[slot] = prompt
            self._psize[slot] = prompt.size
            self._ptr[slot] = 0
            self.pos[slot] = 0
            self.phase[slot] = _PREFILL
            self.stats.admitted += 1
            reset.append(slot)
        if reset:
            keep = np.ones(self.b, bool)
            keep[reset] = False
            with torch.inference_mode():
                self.cache = self._reset(self.cache,
                                         self._dev(keep, torch.bool))

    # paged-serving hooks (no-ops on the contiguous path) --------------------

    def _prefill_grant(self, slot: int, ptr: int, n: int) -> int:
        return n

    def _on_prompt_complete(self, slot: int) -> None:
        pass

    def _first_token(self, slot: int, logits: np.ndarray) -> int:
        req = self.active[slot]
        first = int(np.argmax(logits[slot]))
        req.out.append(first)
        return first

    def _prefill_step(self, t0: float, results: Dict[int, List[int]]) -> None:
        slots = np.flatnonzero(self.phase == _PREFILL)
        if slots.size == 0:
            return
        tok = np.zeros((self.b, self.chunk), np.int64)
        n_valid = np.zeros(self.b, np.int64)
        for slot in slots:
            if self.phase[slot] != _PREFILL:    # preempted by an earlier grant
                continue
            prompt = self._prompt[slot]
            n = min(self.chunk, prompt.size - self._ptr[slot])
            n = self._prefill_grant(slot, int(self._ptr[slot]), int(n))
            if n > 0:
                tok[slot, :n] = prompt[self._ptr[slot]:self._ptr[slot] + n]
            n_valid[slot] = n
        n_valid[self.phase != _PREFILL] = 0
        if not n_valid.any():
            return                              # everyone stalled on pages
        logits = self._step(tok, n_valid)
        self.stats.prefill_steps += 1
        self.stats.prefill_tokens += int(n_valid.sum())
        for slot in slots:
            if self.phase[slot] != _PREFILL:
                continue
            self._ptr[slot] += n_valid[slot]
            self.pos[slot] += n_valid[slot]
            if self._ptr[slot] < self._prompt[slot].size:
                continue
            # prompt complete: the chunk's last-valid logits predict the
            # first output token, which rides the handoff channel into
            # the Execute engine
            req = self.active[slot]
            self._on_prompt_complete(slot)
            first = self._first_token(slot, logits)
            if req.rid not in self.stats.ttft:   # resumes keep the original
                self.stats.ttft[req.rid] = (time.perf_counter() - t0
                                            - req.t_arrival)
            self.remaining[slot] = req.max_new - len(req.out)
            if first == self.eos or self.remaining[slot] <= 0:
                self._finish(slot, results)
            else:
                self.phase[slot] = _HANDOFF
                self.handoff.push((slot, first))

    # -- Execute engine: dense masked decode ---------------------------------

    def _decode_mask(self) -> np.ndarray:
        return self.phase == _DECODE

    def _decode_step(self, results: Dict[int, List[int]]) -> None:
        # absorb freshly prefilled slots: the (slot, first token) entry
        # on the handoff channel is what activates decoding
        while self.handoff:
            slot, first = self.handoff.pop()
            self.cur[slot] = first
            self.phase[slot] = _DECODE
        active = self._decode_mask()
        if not active.any():
            return
        logits = self._step(self.cur[:, None], active.astype(np.int64))
        nxt = np.argmax(logits, axis=-1)
        self.stats.decode_steps += 1
        self.stats.decode_tokens += int(active.sum())
        for slot in np.flatnonzero(active):
            tok = int(nxt[slot])
            req = self.active[slot]
            req.out.append(tok)
            self.cur[slot] = tok
            self.pos[slot] += 1
            self.remaining[slot] -= 1
            if tok == self.eos or self.remaining[slot] <= 0:
                self._finish(slot, results)

    def _finish(self, slot: int, results: Dict[int, List[int]]) -> None:
        req = self.active[slot]
        results[req.rid] = req.out
        self.active[slot] = None
        self._prompt[slot] = None
        self.phase[slot] = _FREE
        self.free_slots.push(slot)

    # -- scheduler -----------------------------------------------------------

    def _reserved_tokens(self) -> int:
        res = 0
        for slot in range(self.b):
            req = self.active[slot]
            if req is not None:
                res += int(self._psize[slot]) + req.max_new
        return res

    def run(self, requests: List[Request], max_rounds: int = 100_000
            ) -> Dict[int, List[int]]:
        results: Dict[int, List[int]] = {}
        _validate_requests(requests, self.s_max)
        t0 = time.perf_counter()
        pending = deque()
        for req in sorted(requests, key=lambda r: r.t_arrival):
            if req.max_new <= 0:
                results[req.rid] = []
            else:
                pending.append(req)
        rounds = 0
        while (pending or self._overflow or self.admit_q
               or (self.phase != _FREE).any()):
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError("serve loop exceeded max_rounds")
            # preempted/backlogged requests re-enter ahead of new arrivals
            while self._overflow and self.admit_q.push(self._overflow[0]):
                self._overflow.popleft()
            now = time.perf_counter() - t0
            while pending and pending[0].t_arrival <= now:
                req = pending.popleft()
                if not self.admit_q.push(req):
                    self._overflow.append(req)
            self._admit()
            self.stats.peak_reserved_tokens = max(
                self.stats.peak_reserved_tokens, self._reserved_tokens())
            self._decode_step(results)
            self._prefill_step(t0, results)
            if (pending and not self.admit_q and not self._overflow
                    and not (self.phase != _FREE).any()):
                wait = pending[0].t_arrival - (time.perf_counter() - t0)
                if wait > 0:                 # open-loop idle: sleep to arrival
                    time.sleep(min(wait, 0.05))
        self.stats.rounds = rounds
        return results


class PagedServeLoop(ServeLoop):
    """The serve pipeline on paged KV (see module docstring).

    ``page`` is the tokens-per-page granularity; ``n_pages`` the physical
    pool size (default: page 0 plus exactly ``batch_slots`` full
    horizons — pass less to oversubscribe); ``low_water`` parks admission
    while fewer than that many pages stay free for the decode stream;
    ``prefix_reuse=False`` disables the prefix cache.
    """

    def __init__(self, cfg, bundle, params, batch_slots: int, s_max: int,
                 eos_id: int = -1, chunk: int = 32, bos_id: int = 0,
                 tracer: Optional[Tracer] = None,
                 admit_capacity: Optional[int] = None,
                 page: int = 16, n_pages: Optional[int] = None,
                 low_water: int = 0, prefix_reuse: bool = True):
        self.page = page
        self._n_pages_arg = n_pages
        self.low_water = low_water
        self._prefix_reuse = prefix_reuse
        super().__init__(cfg, bundle, params, batch_slots, s_max,
                         eos_id=eos_id, chunk=chunk, bos_id=bos_id,
                         tracer=tracer, admit_capacity=admit_capacity)

    def _make_cache(self) -> None:
        bundle = self.bundle
        self.paged = True
        if self.page < 1:
            raise ValueError("page must be >= 1")
        self.npb = -(-self.s_max // self.page)      # blocks per slot horizon
        n_pages = self._n_pages_arg
        if n_pages is None:
            n_pages = 1 + self.b * self.npb
        if n_pages < 1 + self.npb:
            raise ValueError(
                f"n_pages ({n_pages}) must cover the trash page plus one "
                f"full horizon ({self.npb} pages) or no request can finish")
        self.n_pages = n_pages
        self.alloc = PageAllocator(n_pages, self.page)
        self.table = np.zeros((self.b, self.npb), np.int32)   # 0 = trash page
        self.n_blocks = np.zeros(self.b, np.int64)
        self.prefix = PrefixCache() if self._prefix_reuse else None
        self._slot_seq = np.zeros(self.b, np.int64)
        self._seq = 0
        self._resume_out: Dict[int, List[int]] = {}
        self._is_resume = np.zeros(self.b, bool)
        self.cache = bundle.cache_init_paged(self.b, n_pages, self.page)
        self._fwd = bundle.prefill_paged
        self._reset_paged = bundle.cache_reset_paged
        self._copy = bundle.copy_pages

    # -- page machinery ------------------------------------------------------

    def _reclaim(self, need_free: int) -> None:
        """Evict prefix-cache entries LRU-first until ``need_free``
        pages are free (or the cache is empty)."""
        while self.alloc.free_count < need_free:
            if self.prefix is None or not self.prefix.evict_lru(self.alloc):
                return

    def _pick_victim(self, requester: int) -> Optional[int]:
        """Strictly-younger victim (so the oldest slot always makes
        progress — no livelock), preferring decode-phase slots (they
        hold the most pages), youngest first."""
        my_seq = self._slot_seq[requester]
        pref_rank = {_DECODE: 2, _HANDOFF: 1, _PREFILL: 0}
        best, best_key = None, None
        for s in range(self.b):
            if s == requester or self.phase[s] == _FREE:
                continue
            if self._slot_seq[s] <= my_seq:
                continue
            key = (pref_rank[int(self.phase[s])], int(self._slot_seq[s]))
            if best_key is None or key > best_key:
                best, best_key = s, key
        return best

    def _preempt(self, victim: int) -> None:
        """Recompute-style preemption: release the victim's pages and
        park its request (with generated-so-far tokens) back on the
        admit queue; on re-admission the prefill teacher-forces
        prompt + out[:-1], so outputs are identical."""
        req = self.active[victim]
        self._resume_out[req.rid] = req.out if req.out is not None else []
        # drop any pending handoff entry for this slot (pop/push cycle
        # keeps the tracer's occupancy record consistent)
        for _ in range(len(self.handoff)):
            entry = self.handoff.pop()
            if entry[0] != victim:
                self.handoff.push(entry)
        for i in range(int(self.n_blocks[victim])):
            self.alloc.decref(int(self.table[victim, i]))
            self.table[victim, i] = 0
        self.n_blocks[victim] = 0
        self.active[victim] = None
        self._prompt[victim] = None
        self.phase[victim] = _FREE
        self._is_resume[victim] = False
        self.free_slots.push(victim)
        if not self.admit_q.push(req):
            self._overflow.append(req)
        self.stats.preemptions += 1

    def _alloc_page(self, requester: int) -> Optional[int]:
        """Allocate one page for ``requester``, escalating: free list ->
        prefix-cache eviction -> preempt a strictly-younger slot.
        Returns None only when the requester is the youngest holder —
        it then stalls for the round and retries."""
        while True:
            pg = self.alloc.alloc()
            if pg is not None:
                self.stats.page_allocs += 1
                return pg
            if self.prefix is not None and self.prefix.evict_lru(self.alloc):
                continue
            victim = self._pick_victim(requester)
            if victim is None:
                return None
            self._preempt(victim)

    # -- Access engine overrides ---------------------------------------------

    def _admit(self) -> None:
        reset: List[int] = []
        new_lens = np.zeros(self.b, np.int64)
        while self.free_slots and self.admit_q:
            req = self.admit_q.peek()
            prompt = np.asarray(req.prompt, np.int64).reshape(-1)
            if prompt.size == 0:
                prompt = np.array([self.bos], np.int64)
            resume = self._resume_out.get(req.rid)
            if resume:
                # teacher-force the tokens generated before preemption;
                # the last one re-enters decode via the handoff channel
                fill = np.concatenate(
                    [prompt, np.asarray(resume[:-1], np.int64)])
            else:
                fill = prompt
            matched, pages = 0, []
            if self.prefix is not None:
                # at least one token must actually prefill (its logits
                # seed the first output), hence the size-1 cap
                matched, pages = self.prefix.lookup(
                    fill, fill.size - 1, self.alloc)
            total_blocks = -(-fill.size // self.page)
            # a shared partial tail page costs one extra page (COW copy)
            need = (total_blocks - len(pages)
                    + (1 if matched % self.page else 0))
            busy = (self.phase != _FREE).any()
            gate = need + (self.low_water if busy else 0)
            if self.alloc.free_count < gate:
                self._reclaim(gate)
            if self.alloc.free_count < gate:
                for p in pages:             # park: head stays queued
                    self.alloc.decref(p)
                break
            self.admit_q.pop()
            slot = self.free_slots.pop()
            req.out = self._resume_out.pop(req.rid, None) or []
            self._is_resume[slot] = bool(req.out)
            self.active[slot] = req
            self._prompt[slot] = fill
            self._psize[slot] = prompt.size
            self.table[slot, :] = 0
            for i, p in enumerate(pages):
                self.table[slot, i] = p
            self.n_blocks[slot] = len(pages)
            self._ptr[slot] = matched
            self.pos[slot] = matched
            self.phase[slot] = _PREFILL
            self._seq += 1
            self._slot_seq[slot] = self._seq
            self.stats.admitted += 1
            if matched:
                self.stats.prefix_hits += 1
                self.stats.prefix_tokens_reused += matched
            reset.append(slot)
            new_lens[slot] = matched
        if reset:
            keep = np.ones(self.b, bool)
            keep[reset] = False
            with torch.inference_mode():
                self.cache = self._reset_paged(self.cache,
                                               self._dev(keep, torch.bool),
                                               self._dev(new_lens))

    def _prefill_grant(self, slot: int, ptr: int, n: int) -> int:
        """Map pages under [ptr, ptr+n), copy-on-write if the write
        starts inside a shared page; returns how many of the n tokens
        are actually backed (0 = stall this round)."""
        if n <= 0:
            return n
        page = self.page
        if ptr % page:
            blk = ptr // page
            pg = int(self.table[slot, blk])
            if self.alloc.rc[pg] > 1:       # shared partial page: diverging
                fresh = self._alloc_page(slot)
                if fresh is None:
                    return 0
                with torch.inference_mode():
                    self.cache = self._copy(self.cache, pg, fresh)
                self.alloc.decref(pg)
                self.table[slot, blk] = fresh
                self.stats.cow_copies += 1
        last_blk = (ptr + n - 1) // page
        while self.n_blocks[slot] <= last_blk:
            pg = self._alloc_page(slot)
            if pg is None:
                granted = int(self.n_blocks[slot]) * page - ptr
                return max(0, granted)
            self.table[slot, int(self.n_blocks[slot])] = pg
            self.n_blocks[slot] += 1
        return n

    def _on_prompt_complete(self, slot: int) -> None:
        if self.prefix is None:
            return
        fill = self._prompt[slot]
        page = self.page
        bounds = list(range(page, fill.size + 1, page))
        if fill.size % page:
            bounds.append(fill.size)
        for length in bounds:
            nb = -(-length // page)
            pages = [int(self.table[slot, i]) for i in range(nb)]
            self.prefix.register(fill, length, pages, self.alloc)

    def _first_token(self, slot: int, logits: np.ndarray) -> int:
        if self._is_resume[slot]:
            self._is_resume[slot] = False
            return int(self.active[slot].out[-1])
        return super()._first_token(slot, logits)

    # -- Execute engine override ---------------------------------------------

    def _decode_mask(self) -> np.ndarray:
        ready = np.ones(self.b, bool)
        for slot in np.flatnonzero(self.phase == _DECODE):
            if self.phase[slot] != _DECODE:     # preempted earlier this loop
                continue
            blk = int(self.pos[slot]) // self.page
            if blk >= self.n_blocks[slot]:
                pg = self._alloc_page(slot)
                if pg is None:
                    ready[slot] = False         # stall; retry next round
                    continue
                self.table[slot, blk] = pg
                self.n_blocks[slot] += 1
        return (self.phase == _DECODE) & ready

    def _finish(self, slot: int, results: Dict[int, List[int]]) -> None:
        for i in range(int(self.n_blocks[slot])):
            self.alloc.decref(int(self.table[slot, i]))
            self.table[slot, i] = 0
        self.n_blocks[slot] = 0
        super()._finish(slot, results)

    # -- introspection -------------------------------------------------------

    def page_stats(self) -> Dict[str, Any]:
        """Pool occupancy snapshot: fragmentation is the fraction of
        allocated page capacity not holding a live token (page-interior
        waste plus prefix-pinned pages)."""
        used = self.n_pages - 1 - self.alloc.free_count
        committed = int(self.pos[self.phase != _FREE].sum())
        capacity = used * self.page
        return {"n_pages": self.n_pages, "page": self.page,
                "pages_used": used, "pages_free": self.alloc.free_count,
                "committed_tokens": committed,
                "capacity_tokens": capacity,
                "fragmentation": 1.0 - committed / capacity if capacity
                else 0.0,
                "prefix_entries": len(self.prefix) if self.prefix else 0}


class LegacyServeLoop:
    """The coupled pre-rewrite loop, kept as the serving baseline.

    Admission prefills one token at a time through the FULL-BATCH decode
    step, so every active slot stalls for the whole prompt length (and
    has its KV cache polluted once per prompt token — the loop is only
    actually correct for one slot serving one request from a fresh
    cache).  The port keeps the reference's semantics exactly, the
    stalls and the pollution included: it is the comparator the
    decoupled loops are measured against, and its multi-slot streams
    equal the reference's.  ``steps`` counts the full-batch decode steps
    run, prompt tokens included.  The loop runs on the bundle's device.
    """

    def __init__(self, cfg, bundle, params, batch_slots: int, s_max: int,
                 eos_id: int = -1, bos_id: int = 0):
        self.cfg = cfg
        self.bundle = bundle
        self.params = params
        self.device = resolve_device(bundle.device)
        self.b = batch_slots
        self.s_max = s_max
        self.eos = eos_id
        self.bos = bos_id
        self.cache = bundle.cache_init(batch_slots, s_max)
        self.pos = np.zeros(batch_slots, np.int32)
        self.cur = np.zeros(batch_slots, np.int32)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.remaining = np.zeros(batch_slots, np.int64)
        self.steps = 0

    def _step(self, tok: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """One full-batch decode step; logits (B, V) stay on the device."""
        args = [torch.as_tensor(a, dtype=torch.int32, device=self.device)
                for a in (tok, pos)]
        with torch.inference_mode():
            logits, self.cache = self.bundle.decode_step(
                self.params, self.cache, *args)
        self.steps += 1
        return logits

    def _admit(self, queue: List[Request],
               results: Dict[int, List[int]]) -> None:
        for slot in range(self.b):
            if self.active[slot] is None and queue:
                req = queue.pop(0)
                req.out = []
                self.active[slot] = req
                prompt = np.asarray(req.prompt, np.int64).reshape(-1)
                if prompt.size == 0:
                    # empty prompt: generate from an implicit BOS token
                    prompt = np.array([self.bos], np.int64)
                # prefill: feed prompt tokens through the decode step
                pos = 0
                for tok in prompt:
                    cur, at = self.cur.copy(), self.pos.copy()
                    cur[slot], at[slot] = int(tok), pos
                    logits = self._step(cur, at)
                    pos += 1
                first = int(torch.argmax(logits[slot]))
                req.out.append(first)          # prefill's own prediction
                self.pos[slot] = pos
                self.cur[slot] = first
                self.remaining[slot] = req.max_new - 1
                if first == self.eos or self.remaining[slot] <= 0:
                    results[req.rid] = req.out
                    self.active[slot] = None

    def run(self, requests: List[Request], max_rounds: int = 10_000
            ) -> Dict[int, List[int]]:
        _validate_requests(requests, self.s_max)
        queue = []
        results: Dict[int, List[int]] = {}
        for req in requests:
            if req.max_new <= 0:
                results[req.rid] = []
                continue
            queue.append(req)
        rounds = 0
        while (queue or any(a is not None for a in self.active)):
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError("serve loop exceeded max_rounds")
            self._admit(queue, results)
            if not any(a is not None for a in self.active):
                continue
            logits = self._step(self.cur, self.pos)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
            self.pos = self.pos + np.asarray(
                [a is not None for a in self.active], np.int32)
            self.cur = nxt
            for slot, req in enumerate(self.active):
                if req is None:
                    continue
                tok = int(nxt[slot])
                req.out.append(tok)
                self.remaining[slot] -= 1
                if tok == self.eos or self.remaining[slot] <= 0:
                    results[req.rid] = req.out
                    self.active[slot] = None
        return results
