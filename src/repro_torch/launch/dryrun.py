"""Multi-pod dry-run: the counterpart of ``repro.launch.dryrun``.  Shows
that every (architecture x input shape) runs its sharded step as one
rank of the production meshes, and counts what that rank computes,
moves and holds, without hardware.

JAX lowers and compiles each cell on 512 forced host devices and reads
the compiled artifact.  The port compiles nothing, so it runs the step
instead, as one rank, with nothing behind the tensors:

* the process opens torch's ``fake`` process group for the mesh's world
  (every collective returns at once, moving nothing) and builds the
  mesh as a ``RankMesh`` of the production shape, (16, 16)
  ``("data", "model")`` or (2, 16, 16) ``("pod", "data", "model")``;
* under ``FakeTensorMode`` it makes this rank's argument shards on fake
  CPU tensors (parameters by ``init_shards``, the rest from the step's
  own ``meta`` specs, cut by ``cache_shardings`` and the batch rows) and
  calls the step of ``shape.kind`` once.

So the dry-run allocates no memory and uses no card, as the reference's
compiles use none.  The optimizer's step counter alone is a real tensor:
AdamW reads it on the host.

What takes the place of XLA's numbers, field by field:

* ``cost["flops"]``: ``FlopCounterMode``'s total over the step;
* ``cost["bytes accessed"]``: the input and output bytes of every aten
  op that computes (``hlo_stats.OpLog``): an unfused count, larger than
  XLA's;
* ``collectives``: ``hlo_stats.collective_stats`` of the records
  ``parallel/collectives.py::count_collectives`` kept over the step;
* ``op_counts``: ``hlo_stats.count_ops`` of the same dispatch log;
* ``memory``: ``argument_bytes`` the bytes of this rank's argument
  shards; ``output_bytes`` those of what the step returns;
  ``alias_bytes`` those of the arguments it updates in place and returns
  (parameters and moments in training, the cache in serving);
  ``temp_bytes`` ``MemTracker``'s peak over the step less the
  arguments; ``code_bytes`` 0, nothing being generated;
* ``trace_s``: the step's host seconds, in place of ``lower_s`` and
  ``compile_s``.

``cost_corrected`` keeps JAX's record.  The port has no scan: every
layer runs, so ``total`` is the direct count; ``base``,
``per_segment_delta`` and ``segment_counts`` come from probes with 1
and 2 layers a segment, as JAX's, and show that count linear in depth.

Results go to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(incremental; ``--force`` recomputes).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_config, long_context_ok
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import steps
from repro_torch.launch.hlo_stats import (OpLog, collective_stats, count_ops,
                                          kernel_launches)
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import named
from repro_torch.parallel.collectives import count_collectives
from repro_torch.parallel.sharding import (batch_sharding, cache_shardings,
                                           place)

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# make_production_mesh's shapes, its axes the last of ("pod", "data",
# "model")
MESH_SHAPES = {"single": (16, 16), "multi": (2, 16, 16)}


# ---------------------------------------------------------------------------
# Cost probes: JAX's undo XLA's count of a scan body once.  The port runs
# every layer, so its direct count needs no correction; the probes (1 and
# 2 layers a segment) keep JAX's record and show the count linear in
# depth:  total = base + sum_seg (L_seg - 1) * (probe_seg - base).
# ---------------------------------------------------------------------------


def segment_counts(cfg: ModelConfig):
    if cfg.family == "encdec":
        return [cfg.n_enc_layers, cfg.n_layers]
    return [s.count for s in cfg.layer_specs()]


def with_segment_counts(cfg: ModelConfig, counts):
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_enc_layers=counts[0],
                                   n_layers=counts[1], scan_layers=False)
    if cfg.family == "hybrid":
        kinds = [s.kind for s in cfg.layer_specs()]
        pos, globals_ = 0, []
        for kind, c in zip(kinds, counts):
            if kind == "hymba_global":
                globals_.extend(range(pos, pos + c))
            pos += c
        return dataclasses.replace(cfg, n_layers=pos,
                                   global_attn_layers=tuple(globals_),
                                   scan_layers=False)
    if cfg.family == "moe" and cfg.first_dense_layers:
        return dataclasses.replace(cfg, first_dense_layers=counts[0],
                                   n_layers=sum(counts), scan_layers=False)
    return dataclasses.replace(cfg, n_layers=counts[0], scan_layers=False)


# ---------------------------------------------------------------------------
# One rank on fake ranks and fake tensors
# ---------------------------------------------------------------------------


def _refuse_open_group() -> None:
    if dist.is_initialized():
        raise RuntimeError("the dry-run opens its own fake process group; "
                           "a default group is open already")


@contextlib.contextmanager
def fake_ranks(mesh_shape: Tuple[int, ...], rank: int = 0):
    """This process as rank ``rank`` of a ``fake`` process group over
    ``prod(mesh_shape)`` ranks, laid out as a ``RankMesh`` with the last
    ``len(mesh_shape)`` of ``("pod", "data", "model")``; the group is
    destroyed when the block ends, also on error.  Raises if a default
    group is open already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _refuse_open_group()
    world = int(np.prod(mesh_shape))
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        axes = ("pod", "data", "model")[-len(mesh_shape):]
        yield make_debug_mesh(tuple(mesh_shape), axes, ranks=True)
    finally:
        dist.destroy_process_group()


def build_cell(cfg: ModelConfig, shape: InputShape, mesh):
    """``(step, arg_specs)`` of the sharded step of ``shape.kind``, on
    the CPU (the dry-run's tensors are fake CPU tensors)."""
    if shape.kind == "train":
        return steps.shard_train_step(cfg, mesh, shape, device="cpu")
    if shape.kind == "prefill":
        return steps.shard_prefill_step(cfg, mesh, shape, device="cpu")
    return steps.shard_serve_step(cfg, mesh, shape, device="cpu")


def _zeros(tree):
    """A fake zero tensor for every ``meta`` spec of ``tree``."""
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros(v) for v in tree)
    return torch.zeros(tree.shape, dtype=tree.dtype)


def _batch(tree, mesh):
    """This rank's rows of every leaf of the batch specs ``tree``."""
    return place(_zeros(tree), mesh,
                 {k: batch_sharding(mesh, v.dim()) for k, v in tree.items()})


def _rank_args(cfg: ModelConfig, shape: InputShape, mesh, specs,
               step_counter: torch.Tensor) -> tuple:
    """This rank's arguments of the step, under ``FakeTensorMode``."""
    params = steps.init_shards(cfg, torch.Generator(), mesh,
                               dtype=cfg.pdtype)
    if shape.kind == "train":
        opt = steps.default_optimizer().init(params)
        return params, opt._replace(step=step_counter), _batch(specs[2],
                                                               mesh)
    if shape.kind == "prefill":
        return params, _batch(specs[1], mesh)
    cache_specs, token, pos = specs[1:4]
    cache = place(_zeros(cache_specs), mesh,
                  cache_shardings(cache_specs, mesh))
    rows = {"token": token, "pos": pos}
    if shape.global_batch % steps._dp_size(mesh):   # every rank all rows
        rows = _zeros(rows)
    else:
        rows = _batch(rows, mesh)
    args = (params, cache, rows["token"], rows["pos"])
    if cfg.family == "encdec":
        args += (_batch({"enc_out": specs[4]}, mesh)["enc_out"],)
    return args


def _tensors(tree) -> Dict[int, torch.Tensor]:
    """Every tensor of ``tree`` (modules, named tuples, dicts, lists), by
    identity."""
    if isinstance(tree, torch.Tensor):
        return {id(tree): tree}
    if isinstance(tree, torch.nn.Module):
        return {id(t): t for t in named(tree).values()}
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    out: Dict[int, torch.Tensor] = {}
    for v in items:
        out.update(_tensors(v))
    return out


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _storage(t: torch.Tensor):
    from torch.multiprocessing.reductions import StorageWeakRef
    return StorageWeakRef(t.untyped_storage())


def dry_run(cfg: ModelConfig, shape: InputShape, mesh) -> Dict[str, Any]:
    """One call of ``cfg``'s sharded step on ``shape`` as this rank of
    ``mesh`` (a :func:`fake_ranks` mesh): the record's ``memory``,
    ``cost``, ``collectives``, ``op_counts``, ``n_devices`` and
    ``trace_s``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    step_counter = torch.zeros((), dtype=torch.int32)   # read on the host
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, specs = build_cell(cfg, shape, mesh)
        args = _rank_args(cfg, shape, mesh, specs, step_counter)
        arg_tensors = _tensors(args)
        tracker = MemTracker()
        tracker.track_external(*arg_tensors.values())
        flops, log = FlopCounterMode(display=False), OpLog()
        launches = kernel_launches()
        t0 = time.perf_counter()
        # the log below the counter, which decomposes the composite ops
        # (inference mode hands it matmul and einsum whole)
        with tracker, log, flops, count_collectives() as tally:
            out = step(*args)
        trace_s = time.perf_counter() - t0
        launches = kernel_launches() - launches
    outs = _tensors(out).values()
    argument = _bytes(arg_tensors.values())
    held = {_storage(t) for t in arg_tensors.values()}
    peak = sum(d["Total"] for d in
               tracker.get_tracker_snapshot("peak").values())
    return {"memory": {
                "argument_bytes": argument,
                "output_bytes": _bytes(outs),
                "temp_bytes": max(0, peak - argument),
                "alias_bytes": _bytes(t for t in outs
                                      if _storage(t) in held),
                "code_bytes": 0},
            "cost": {"flops": float(flops.get_total_flops()),
                     "bytes accessed": float(log.bytes)},
            "collectives": collective_stats(tally),
            "op_counts": count_ops(log.ops, launches),
            "n_devices": mesh.size, "trace_s": round(trace_s, 2)}


def _totals(rec: Dict[str, Any]) -> Dict[str, float]:
    """A record's four counts that ``cost_corrected`` carries."""
    coll = rec["collectives"]["_total"]
    return {"flops": rec["cost"]["flops"],
            "bytes": rec["cost"]["bytes accessed"],
            "link_bytes": float(coll["link_bytes"]),
            "coll_payload": float(coll["payload_bytes"])}


def _probe_metrics(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    return _totals(dry_run(cfg, shape, mesh))


def corrected_cost(cfg: ModelConfig, shape: InputShape, mesh,
                   total: Optional[dict] = None) -> dict:
    """JAX's ``cost_corrected`` record: ``total`` the direct count
    (measured here unless given), ``base`` and ``per_segment_delta``
    from probes with 1 and 2 layers a segment."""
    counts = segment_counts(cfg)
    base_counts = [1] * len(counts)
    base = _probe_metrics(with_segment_counts(cfg, base_counts), shape, mesh)
    deltas = []
    for i in range(len(counts)):
        probe_counts = list(base_counts)
        probe_counts[i] = 2
        probe = _probe_metrics(with_segment_counts(cfg, probe_counts), shape,
                               mesh)
        deltas.append({k: probe[k] - base[k] for k in base})
    if total is None:
        total = _probe_metrics(cfg, shape, mesh)
    return {"total": total, "base": base,
            "per_segment_delta": deltas, "segment_counts": counts}


def cell_should_run(arch: str, shape: InputShape) -> bool:
    if shape.name == "long_500k" and not long_context_ok(arch):
        return False
    return True


def skip_reason(arch: str, shape: InputShape) -> str:
    return ("long_500k needs sub-quadratic attention; this arch is pure "
            "full-attention (docs/architecture.md §\"Model families and "
            "input shapes\")")


def measure_cell(rec: dict, cfg: ModelConfig, shape: InputShape,
                 mesh_shape: Tuple[int, ...], rank: int = 0) -> dict:
    """``rec`` with the fields of :func:`dry_run` and ``cost_corrected``
    for rank ``rank`` of a fake mesh of ``mesh_shape``, and ``status``
    ``"ok"``; or ``status`` ``"error"`` with the error and its
    traceback.  Raises, before anything runs, if a default process group
    is open."""
    _refuse_open_group()
    try:
        with fake_ranks(mesh_shape, rank) as mesh:
            fields = dry_run(cfg, shape, mesh)
            fields["cost_corrected"] = corrected_cost(cfg, shape, mesh,
                                                      _totals(fields))
        rec.update(status="ok", **fields)
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug to record
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, force: bool = False,
             out_dir: Path = OUT_DIR, overrides: dict | None = None,
             variant: str = "") -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}__{shape_name}__{mesh_kind}"
    if variant:
        tag += f"__{variant}"
    out_path = out_dir / f"{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "kind": shape.kind, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch, "variant": variant,
           "overrides": overrides or {}}

    if not cell_should_run(arch, shape):
        rec["status"] = "skipped"
        rec["reason"] = skip_reason(arch, shape)
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    cfg = get_config(arch, kernel_mode="ref", **(overrides or {}))
    measure_cell(rec, cfg, shape, MESH_SHAPES[mesh_kind])
    if rec["status"] == "ok":
        tot = rec["cost_corrected"]["total"]
        print(f"[dryrun] {tag}: OK trace={rec['trace_s']:.1f}s "
              f"flops/dev={tot['flops']:.3e} "
              f"link_bytes/dev={tot['link_bytes']:.3e}")
    else:
        print(f"[dryrun] {tag}: FAIL {rec['error'][:200]}")
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="", help="tag for override runs")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. attn_impl=chunked)")
    ns = ap.parse_args()

    overrides = {}
    for kv in ns.set:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            v = {"true": True, "false": False}.get(v.lower(), v)
        overrides[k] = v

    archs = [ns.arch] if ns.arch else list(ARCHS)
    shapes = [ns.shape] if ns.shape else list(SHAPES)
    meshes = ["single", "multi"] if ns.mesh == "both" else [ns.mesh]

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                rec = run_cell(arch, shape, mesh_kind, force=ns.force,
                               overrides=overrides, variant=ns.variant)
                s = rec["status"]
                n_ok += s == "ok"
                n_fail += s == "error"
                n_skip += s == "skipped"
    print(f"[dryrun] done: ok={n_ok} skipped={n_skip} failed={n_fail}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
