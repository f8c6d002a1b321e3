"""Mesh-placed decoupled serving: the paged pipeline over devices (the
port's counterpart of ``repro.runtime.mesh_serve``).

:class:`ShardedPagedServeLoop` is :class:`~repro_torch.runtime.
serve_loop.PagedServeLoop` with its engines *placed*: the parameters
and the KV page pool live on the decode mesh, and the engine-joining
channels become :class:`~repro_torch.channels.mesh.MeshChannel` rings
whose control messages travel between the mesh's slots.

Two placements (:func:`~repro_torch.launch.mesh.make_serve_meshes`):

  * **co-located**: one mesh runs both engines; ``handoff`` and
    ``free_slots`` ride its ``data`` axis from slot 0 to the last slot.
    n=1 is bit-identical to ``PagedServeLoop``.
  * **disaggregated**: Access (prefill) and Execute (decode) run on the
    two halves of a union mesh joined *only* by mesh channels over its
    ``role`` axis.  Prefill writes a private staging pool of
    ``1 + b*npb`` pages (a concurrent prefill can never run it dry) with
    its own allocator and table; on prompt completion the slot's pages
    migrate to the decode pool in pool layout
    (``bundle.gather_pages``/``scatter_pages``).  If the decode pool
    cannot back the migration even after preemption, the slot preempts
    *itself* and re-enters admission (its teacher-forced resume keeps
    the outputs identical).  Prefix reuse is forced off: staging pages
    are transient, so sharing them across requests would dangle across
    the migration.

Two kinds of mesh:

  * **logical devices** (one process): each engine mesh names one
    physical device (several slots may name it; an engine mesh over
    several raises).  The engines may sit on two cards; each engine's
    steps and its half of a migration run with its card current, and a
    migration hops through the host (device -> host -> device, as JAX's
    ``jax.device_get``).
  * **ranks** (:class:`~repro_torch.launch.mesh.RankMesh`, one process
    a rank, every rank running this loop with the same requests): the
    parameters are replicated (JAX's ``ShardingRules(fsdp=False,
    seq_shard_cache=False)``) and each pool is placed by
    ``cache_shardings``: its page dimension shards over ``data`` where
    the engine's ``data`` size divides the page count, and is replicated
    otherwise.  A sharded pool is gathered whole in each layer's step
    and each rank keeps its slice back (``parallel/sharding.py``'s
    :func:`~repro_torch.parallel.sharding.pool_shards`), as GSPMD runs
    the reference's unpartitioned kernel, so the result is the one
    device's.  Every rank keeps the same host state (queues, allocators,
    tables, counters): an engine's step runs on its ranks, and its
    logits are broadcast from the engine's first rank to every rank, so
    no rank decides on a value it did not see; admission reads rank 0's
    clock.  A migration gathers the slot's pages on the prefill ranks,
    broadcasts them from the first prefill rank, and each decode rank
    writes the pages it holds.

A migration moves only the slot's real pages, where JAX pads the page
list to ``npb`` with trash page 0 (the port runs eagerly, so there is
no compile to share across prompt lengths; page 0 is never attended).
Each migration's pages, bytes and wall (gather + hop + scatter, ended
by a device synchronise) are kept in ``migration_log``.

Families without paged primitives (recurrent state, the
encoder-decoder) keep the contiguous path of the base class: both
engines drive one dense cache (on rank meshes every rank runs every
step on its own copy) and only the control channels are mesh-placed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from repro_torch.channels import LocalChannel, MeshChannel
from repro_torch.launch.mesh import (RankMesh, ServeMeshes,
                                     make_serve_meshes)
from repro_torch.models.registry import build_model
from repro_torch.parallel.collectives import broadcast
from repro_torch.parallel.sharding import (ShardingRules, cache_shardings,
                                           engine_device, param_shardings,
                                           place, pool_shards)
from repro_torch.runtime.serve_loop import PageAllocator, PagedServeLoop

__all__ = ["Migration", "ShardedPagedServeLoop"]

# serving shards the pool only: whole parameters keep every rank's
# outputs equal to one device's (the reference's rules)
_RULES = ShardingRules(fsdp=False, seq_shard_cache=False)
_POOL_KEYS = ("kp", "vp", "ckvp", "krp")


@dataclasses.dataclass(frozen=True)
class Migration:
    """One prefill->decode page migration."""

    slot: int
    pages: int
    bytes: int
    seconds: float


def _current(dev: torch.device):
    """``dev`` the current card inside the block (nothing on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _pool_split(cache, mesh) -> bool:
    """Whether ``cache_shardings`` shards the pool of ``cache`` over
    ``mesh``."""
    specs = cache_shardings(cache, mesh, _RULES)
    return any(e is not None for seg in specs
               for k, sh in seg["attn"].items() if k in _POOL_KEYS
               for e in sh.spec)


class ShardedPagedServeLoop(PagedServeLoop):
    """Paged decoupled serving with device placement (module docstring).

    ``meshes`` defaults to a one-slot co-located placement on the
    bundle's device (the bit-parity configuration).
    """

    def __init__(self, cfg, bundle, params, batch_slots: int, s_max: int,
                 meshes: Optional[ServeMeshes] = None, **kw):
        self.meshes = meshes if meshes is not None else \
            make_serve_meshes(1, devices=[bundle.device])
        self._ranked = isinstance(self.meshes.union, RankMesh)
        if self._ranked and not self.meshes.union.member:
            raise ValueError(f"rank {self.meshes.union.rank} is not on the "
                             f"serving meshes {self.meshes.union}")
        self._dev_decode = engine_device(self.meshes.decode)
        self._dev_prefill = engine_device(self.meshes.prefill)
        self._disagg = self.meshes.disaggregated
        self._engine = "execute"
        self._split = {"access": False, "execute": False}
        self.migration_log: List[Migration] = []
        if self._disagg:
            kw["prefix_reuse"] = False
        if (self._ranked or self.meshes.decode.size > 1) and \
                cfg.mesh_pool_axis is None:
            cfg = dataclasses.replace(cfg, mesh_pool_axis=self.meshes.axis)
        if self._ranked:
            # the model reads mesh_pool_axis, and runs on this rank's device
            bundle = build_model(cfg, device=self.meshes.union.device)
        super().__init__(cfg, bundle, params, batch_slots, s_max, **kw)

    # -- placement -----------------------------------------------------------

    def _make_channels(self) -> None:
        self.admit_q = LocalChannel("admit", self._admit_capacity,
                                    self.tracer)
        if self._disagg:
            um, ax = self.meshes.union, self.meshes.role_axis
            self.handoff = MeshChannel("prefill_done", self.b, um, ax,
                                       src=0, dst=1, tracer=self.tracer)
            self.free_slots = MeshChannel("free_slots", self.b, um, ax,
                                          src=1, dst=0, tracer=self.tracer)
        else:
            dm = self.meshes.decode
            span = int(dm.shape[self.meshes.axis])
            self.handoff = MeshChannel("prefill_done", self.b, dm,
                                       self.meshes.axis, src=0,
                                       dst=span - 1, tracer=self.tracer)
            self.free_slots = MeshChannel("free_slots", self.b, dm,
                                          self.meshes.axis, src=span - 1,
                                          dst=0, tracer=self.tracer)

    def _put(self, tree, mesh, params: bool = False):
        """``tree`` placed on ``mesh``: by the serving rules' specs on a
        rank mesh (``None`` on a rank the mesh does not hold)."""
        if not self._ranked:
            return place(tree, mesh)
        rule = param_shardings if params else cache_shardings
        return place(tree, mesh, rule(tree, mesh, _RULES))

    def _make_cache(self) -> None:
        super()._make_cache()
        if not self.paged:
            return
        dm, params = self.meshes.decode, self.params
        self.device = self._dev_decode
        if self._ranked:
            # each pool leaf's (count, pages, ...) layout: what a rank
            # that holds no pool receives in a migration
            self._layout = [
                {k: (v.shape[0], tuple(v.shape[2:]), v.dtype)
                 for k, v in seg["attn"].items() if k in _POOL_KEYS}
                for seg in self.cache]
            self._split["execute"] = _pool_split(self.cache, dm)
            if self._split["execute"]:
                self._copy = self._copy_sharded
        self.params = self._put(params, dm, params=True)
        self.cache = self._put(self.cache, dm)
        if self._disagg:
            pm = self.meshes.prefill
            self._params_pf = self._put(params, pm, params=True)
            # staging pool: every slot holds at most npb pages, so
            # 1 + b*npb (trash page + b horizons) can never run dry
            self.n_pages_pf = 1 + self.b * self.npb
            self.alloc_pf = PageAllocator(self.n_pages_pf, self.page)
            self.table_pf = np.zeros((self.b, self.npb), np.int32)
            self.n_blocks_pf = np.zeros(self.b, np.int64)
            staging = self.bundle.cache_init_paged(self.b, self.n_pages_pf,
                                                   self.page)
            if self._ranked:
                self._split["access"] = _pool_split(staging, pm)
            self.cache_pf = self._put(staging, pm)

    # -- engine routing ------------------------------------------------------

    def _access_engine(self) -> bool:
        """Whether the step about to run is the disaggregated prefill's."""
        return self.paged and self._disagg and self._engine == "access"

    def _step_mesh(self):
        """The mesh whose ranks run the step about to run."""
        if not self.paged:
            return self.meshes.union
        return self.meshes.prefill if self._access_engine() else \
            self.meshes.decode

    @contextlib.contextmanager
    def _on(self, engine: str) -> Iterator[None]:
        """An engine's device current and, when its pool is sharded over
        ranks, its pool gathered in each layer."""
        access = engine == "access" and self._disagg
        with _current(self._dev_prefill if access else self._dev_decode):
            if self._split[engine]:
                with pool_shards(self.meshes.prefill if access
                                 else self.meshes.decode):
                    yield
            else:
                yield

    def _prefill_step(self, t0, results) -> None:
        self._engine = "access"
        try:
            super()._prefill_step(t0, results)
        finally:
            self._engine = "execute"

    def _logits(self, tok, n_valid):
        if not self._access_engine():
            with self._on("execute"):
                return super()._logits(tok, n_valid)
        saved = (self.params, self.cache, self.table, self.device)
        self.params, self.cache = self._params_pf, self.cache_pf
        self.table, self.device = self.table_pf, self._dev_prefill
        try:
            with self._on("access"):
                return super()._logits(tok, n_valid)
        finally:
            self.cache_pf = self.cache
            self.params, self.cache, self.table, self.device = saved

    def _step(self, tok, n_valid):
        if not self._ranked:
            return super()._step(tok, n_valid)
        um, mesh = self.meshes.union, self._step_mesh()
        if mesh.member:
            logits = self._logits(tok, n_valid)
        else:
            logits = torch.empty((self.b, self.cfg.vocab),
                                 dtype=torch.float32, device=um.device)
        first = um.ranks.reshape(-1).tolist().index(int(mesh.ranks.flat[0]))
        return broadcast(logits, um, None, first).cpu().numpy()

    def _clock(self, t0: float) -> float:
        now = super()._clock(t0)
        if not self._ranked:
            return now
        um = self.meshes.union
        return float(broadcast(torch.tensor([now], dtype=torch.float64,
                                            device=um.device), um, None, 0))

    # -- disaggregated page life cycle ---------------------------------------

    def _release_pf(self, slot: int) -> None:
        for i in range(int(self.n_blocks_pf[slot])):
            self.alloc_pf.decref(int(self.table_pf[slot, i]))
            self.table_pf[slot, i] = 0
        self.n_blocks_pf[slot] = 0

    def _prefill_grant(self, slot: int, ptr: int, n: int) -> int:
        if not (self.paged and self._disagg):
            return super()._prefill_grant(slot, ptr, n)
        if n <= 0:
            return n
        last_blk = (ptr + n - 1) // self.page
        while self.n_blocks_pf[slot] <= last_blk:
            pg = self.alloc_pf.alloc()
            if pg is None:
                raise RuntimeError("the staging pool ran dry; it is sized "
                                   "to hold every slot's horizon")
            self.table_pf[slot, int(self.n_blocks_pf[slot])] = pg
            self.n_blocks_pf[slot] += 1
            self.stats.page_allocs += 1
        return n

    def _on_prompt_complete(self, slot: int) -> None:
        if not (self.paged and self._disagg):
            return super()._on_prompt_complete(slot)
        # migrate the finished prompt's staging pages into the decode
        # pool; on failure the slot preempts itself (the base
        # _prefill_step then skips its handoff)
        nb = int(self.n_blocks_pf[slot])
        dst: List[int] = []
        for _ in range(nb):
            # _alloc_page may preempt *other* (strictly younger) slots;
            # this slot's staging pages and phase are untouched by that
            pg = self._alloc_page(slot)
            if pg is None:
                for p in dst:
                    self.alloc.decref(p)
                self._preempt(slot)
                return
            dst.append(pg)
        src = [int(self.table_pf[slot, i]) for i in range(nb)]
        self._migrate(src, dst, slot, int(self.pos[slot]))
        for i, p in enumerate(dst):
            self.table[slot, i] = p
        self.n_blocks[slot] = nb
        self._release_pf(slot)

    def _migrate(self, src: List[int], dst: List[int], slot: int,
                 new_len: int) -> None:
        """Move pages ``src`` (staging pool) to ``dst`` (decode pool) in
        pool layout and set the slot's decode length to ``new_len``."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            if self._ranked:
                blocks = self._migrate_ranks(src, dst, slot, new_len)
            else:
                with self._on("access"):
                    blocks = self.bundle.gather_pages(
                        self.cache_pf, self._index(src, self._dev_prefill))
                # the prefill -> decode hop goes through the host
                blocks = [{k: v.cpu().to(self.device)
                           for k, v in blk.items()} for blk in blocks]
                with self._on("execute"):
                    self.cache = self.bundle.scatter_pages(
                        self.cache, blocks, self._index(dst, self.device),
                        slot, new_len)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        nbytes = sum(v.numel() * v.element_size()
                     for blk in blocks for v in blk.values())
        self.migration_log.append(Migration(
            slot, len(src), nbytes, time.perf_counter() - t0))
        self.stats.migrations += 1

    @staticmethod
    def _index(pages: List[int], dev: torch.device) -> torch.Tensor:
        return torch.as_tensor(pages, dtype=torch.long, device=dev)

    def _empty_blocks(self, n: int, dev: torch.device):
        return [{k: torch.empty((count, n) + rest, dtype=dtype, device=dev)
                 for k, (count, rest, dtype) in seg.items()}
                for seg in self._layout]

    def _migrate_ranks(self, src, dst, slot, new_len):
        """The migration over rank meshes: the prefill ranks gather the
        pages, the first of them broadcasts them to every rank, and each
        decode rank writes the pages its pool shard holds.  Returns the
        moved blocks."""
        pm, dm, um = self.meshes.prefill, self.meshes.decode, \
            self.meshes.union
        if pm.member:
            with self._on("access"):
                blocks = self._gather_owned(self.cache_pf, src, pm,
                                            self._split["access"])
        else:
            blocks = self._empty_blocks(len(src), um.device)
        first = um.ranks.reshape(-1).tolist().index(int(pm.ranks.flat[0]))
        blocks = [{k: broadcast(v, um, None, first) for k, v in blk.items()}
                  for blk in blocks]
        if dm.member:
            with self._on("execute"):
                pos, local = self._held(dst, dm, self._split["execute"],
                                        self.cache)
                sel = self._index(pos, self.device)
                self.cache = self.bundle.scatter_pages(
                    self.cache,
                    [{k: v.index_select(1, sel) for k, v in blk.items()}
                     for blk in blocks],
                    self._index(local, self.device), slot, new_len)
        return blocks

    def _held(self, pages, mesh, split: bool, cache):
        """The positions in ``pages`` of the pages this rank's pool shard
        holds, and their local page numbers (all of them, unsplit)."""
        if not split:
            return list(range(len(pages))), list(pages)
        n = next(v.shape[1] for v in cache[0]["attn"].values()
                 if v.dim() > 2)
        lo = mesh.axis_index(self.meshes.axis) * n
        pos = [j for j, p in enumerate(pages) if lo <= p < lo + n]
        return pos, [pages[j] - lo for j in pos]

    def _gather_owned(self, cache, pages, mesh, split: bool):
        """Pages ``pages`` of the pool ``cache`` on ``mesh``, on every
        rank of it: gathered locally from a replicated pool, else each
        owner broadcasts the pages its shard holds along ``data``."""
        if not split:
            return self.bundle.gather_pages(
                cache, self._index(pages, mesh.device))
        ax = self.meshes.axis
        n = next(v.shape[1] for v in cache[0]["attn"].values()
                 if v.dim() > 2)
        out = self._empty_blocks(len(pages), mesh.device)
        for owner in sorted({p // n for p in pages}):
            pos = [j for j, p in enumerate(pages) if p // n == owner]
            if mesh.axis_index(ax) == owner:
                part = self.bundle.gather_pages(cache, self._index(
                    [pages[j] - owner * n for j in pos], mesh.device))
            else:
                part = self._empty_blocks(len(pos), mesh.device)
            idx = self._index(pos, mesh.device)
            for blk, got in zip(out, part):
                for k, v in got.items():
                    blk[k].index_copy_(1, idx, broadcast(v, mesh, ax, owner))
        return out

    def _copy_sharded(self, cache, src: int, dst: int):
        """Copy-on-write over a pool sharded on ``data``: the rank that
        holds page ``src`` broadcasts it, the one that holds ``dst``
        writes it."""
        dm, ax = self.meshes.decode, self.meshes.axis
        me = dm.axis_index(ax)
        for seg in cache:
            for key in _POOL_KEYS:
                if key not in seg["attn"]:
                    continue
                a = seg["attn"][key]
                n = a.shape[1]
                row = a[:, src % n].clone() if me == src // n else \
                    torch.empty_like(a[:, 0])
                row = broadcast(row, dm, ax, src // n)
                if me == dst // n:
                    a[:, dst % n] = row
        return cache

    def _preempt(self, victim: int) -> None:
        if self.paged and self._disagg:
            self._release_pf(victim)
        super()._preempt(victim)

    def _reset_slots(self, reset, keep, new_lens) -> None:
        if self.paged and self._disagg:
            self.table_pf[reset, :] = 0          # freed rows stay zeroed
            if self.cache_pf is not None:
                dev = self._dev_prefill
                with torch.inference_mode():
                    self.cache_pf = self._reset_paged(
                        self.cache_pf, torch.as_tensor(keep, device=dev),
                        torch.as_tensor(new_lens, dtype=torch.int32,
                                        device=dev))
        if self.cache is not None:
            super()._reset_slots(reset, keep, new_lens)
