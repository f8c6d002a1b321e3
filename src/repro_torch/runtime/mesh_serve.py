"""Mesh-placed decoupled serving: the paged pipeline over devices (the
port's counterpart of ``repro.runtime.mesh_serve``).

:class:`ShardedPagedServeLoop` is :class:`~repro_torch.runtime.
serve_loop.PagedServeLoop` with its engines *placed*: the parameters
and the KV page pool live on the decode mesh's device, and the
engine-joining channels become :class:`~repro_torch.channels.mesh.
MeshChannel` rings whose control messages travel between the mesh's
slots.

Two placements (:func:`~repro_torch.launch.mesh.make_serve_meshes`):

  * **co-located**: one mesh runs both engines; ``handoff`` and
    ``free_slots`` ride its ``data`` axis from slot 0 to the last slot.
    n=1 is bit-identical to ``PagedServeLoop``.
  * **disaggregated**: Access (prefill) and Execute (decode) run on the
    two halves of a union mesh joined *only* by mesh channels over its
    ``role`` axis.  Prefill writes a private staging pool of
    ``1 + b*npb`` pages (a concurrent prefill can never run it dry) with
    its own allocator and table; on prompt completion the slot's pages
    migrate to the decode pool in pool layout: gather on the prefill
    engine's device, a host hop (device -> host -> device, as JAX's
    ``jax.device_get``), scatter into the decode pool
    (``bundle.gather_pages``/``scatter_pages``).  If the decode pool
    cannot back the migration even after preemption, the slot preempts
    *itself* and re-enters admission (its teacher-forced resume keeps
    the outputs identical).  Prefix reuse is forced off: staging pages
    are transient, so sharing them across requests would dangle across
    the migration.

Differences from the reference: the port runs eagerly, so there is no
compile to share across prompt lengths, and a migration moves only the
slot's real pages where JAX pads the page list to ``npb`` with trash
page 0.  The results are the same, since page 0 is never attended.
Each migration's pages, bytes and wall (gather + host hop + scatter,
ended by a device synchronise) are kept in ``migration_log``.

An engine mesh is one physical device (several slots may name it); a
mesh over several GPUs raises (``parallel/sharding.py``'s
:func:`~repro_torch.parallel.sharding.engine_device`), and so do
prefill and decode engines on two different physical devices: the
port's CUDA wrappers launch on their tensors' streams without making
that device current, so no placement but one device serves yet.  The
config's ``mesh_pool_axis`` is set as JAX sets it, and nothing reads
it.

Families without paged primitives (recurrent state, the
encoder-decoder) keep the contiguous path of the base class: both
engines drive one dense cache and only the control channels are
mesh-placed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.channels import LocalChannel, MeshChannel
from repro_torch.launch.mesh import ServeMeshes, make_serve_meshes
from repro_torch.parallel.sharding import engine_device, place
from repro_torch.runtime.serve_loop import PageAllocator, PagedServeLoop

__all__ = ["Migration", "ShardedPagedServeLoop"]


@dataclasses.dataclass(frozen=True)
class Migration:
    """One prefill->decode page migration."""

    slot: int
    pages: int
    bytes: int
    seconds: float


class ShardedPagedServeLoop(PagedServeLoop):
    """Paged decoupled serving with device placement (module docstring).

    ``meshes`` defaults to a one-slot co-located placement on the
    bundle's device (the bit-parity configuration).
    """

    def __init__(self, cfg, bundle, params, batch_slots: int, s_max: int,
                 meshes: Optional[ServeMeshes] = None, **kw):
        self.meshes = meshes if meshes is not None else \
            make_serve_meshes(1, devices=[bundle.device])
        self._dev_decode = engine_device(self.meshes.decode)
        self._dev_prefill = engine_device(self.meshes.prefill)
        if self._dev_prefill != self._dev_decode:
            raise NotImplementedError(
                f"prefill engine on {self._dev_prefill}, decode engine on "
                f"{self._dev_decode}: engines on distinct physical devices "
                "are not yet ported (ROADMAP.md §A4, the collective half)")
        self._disagg = self.meshes.disaggregated
        self._engine = "execute"
        self.migration_log: List[Migration] = []
        if self._disagg:
            kw["prefix_reuse"] = False
        if self.meshes.decode.size > 1 and cfg.mesh_pool_axis is None:
            cfg = dataclasses.replace(cfg, mesh_pool_axis=self.meshes.axis)
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

    def _make_cache(self) -> None:
        super()._make_cache()
        if not self.paged:
            return
        self.device = self._dev_decode
        self.params = place(self.params, self.meshes.decode)
        self.cache = place(self.cache, self.meshes.decode)
        if self._disagg:
            pm = self.meshes.prefill
            self._params_pf = place(self.params, pm)
            # staging pool: every slot holds at most npb pages, so
            # 1 + b*npb (trash page + b horizons) can never run dry
            self.n_pages_pf = 1 + self.b * self.npb
            self.alloc_pf = PageAllocator(self.n_pages_pf, self.page)
            self.table_pf = np.zeros((self.b, self.npb), np.int32)
            self.n_blocks_pf = np.zeros(self.b, np.int64)
            self.cache_pf = place(self.bundle.cache_init_paged(
                self.b, self.n_pages_pf, self.page), pm)

    # -- engine routing ------------------------------------------------------

    def _prefill_step(self, t0, results) -> None:
        self._engine = "access"
        try:
            super()._prefill_step(t0, results)
        finally:
            self._engine = "execute"

    def _step(self, tok, n_valid):
        if not (self.paged and self._disagg and self._engine == "access"):
            return super()._step(tok, n_valid)
        saved = (self.params, self.cache, self.table, self.device)
        self.params, self.cache = self._params_pf, self.cache_pf
        self.table, self.device = self.table_pf, self._dev_prefill
        try:
            return super()._step(tok, n_valid)
        finally:
            self.cache_pf = self.cache
            self.params, self.cache, self.table, self.device = saved

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
            blocks = self.bundle.gather_pages(self.cache_pf, torch.as_tensor(
                src, dtype=torch.long, device=self._dev_prefill))
            # the prefill -> decode hop goes through the host
            blocks = [{k: v.cpu().to(self.device) for k, v in blk.items()}
                      for blk in blocks]
            self.cache = self.bundle.scatter_pages(
                self.cache, blocks, torch.as_tensor(
                    dst, dtype=torch.long, device=self.device),
                slot, new_len)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        nbytes = sum(v.numel() * v.element_size()
                     for blk in blocks for v in blk.values())
        self.migration_log.append(Migration(
            slot, len(src), nbytes, time.perf_counter() - t0))
        self.stats.migrations += 1

    def _preempt(self, victim: int) -> None:
        if self.paged and self._disagg:
            self._release_pf(victim)
        super()._preempt(victim)

    def _reset_slots(self, reset, keep, new_lens) -> None:
        if self.paged and self._disagg:
            self.table_pf[reset, :] = 0          # freed rows stay zeroed
            dev = self._dev_prefill
            with torch.inference_mode():
                self.cache_pf = self._reset_paged(
                    self.cache_pf, torch.as_tensor(keep, device=dev),
                    torch.as_tensor(new_lens, dtype=torch.int32,
                                    device=dev))
        super()._reset_slots(reset, keep, new_lens)
