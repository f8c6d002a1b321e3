#!/usr/bin/env python3
"""Serve one model over several cards: one engine over ranks, and two
engines on two cards of one process.

    python3 tools/mesh_dist.py            # every visible card (2 or more)
    python3 tools/mesh_dist.py --cpu 4    # rehearsal: 4 gloo ranks, CPU

On the cards it builds the CUDA kernels once, then in this process
builds qwen3-4b at full width (``chip_smoke.py``'s phase 5 build,
seeded, and its 8 requests) and serves the requests three times on card
0: ``PagedServeLoop`` with ``n_pages`` rounded up to a multiple of the
card count (516 for four: 129 pages a card), the same with
``prefix_reuse=False``, and ``ShardedPagedServeLoop`` with its prefill
engine on card 0 and its decode engine on card 1
(``make_serve_meshes(2, devices=[cuda:0, cuda:1])``).  Then it spawns
one rank per card (``nccl``, ``repro_torch.launch.spawn``); each builds
the same weights and serves the requests on rank meshes, co-located over
every card and disaggregated half and half, with that ``n_pages``, so
the pools shard over ``data``.

It prints the card's name and power limit, and per placement: streams
equal to the matching ``PagedServeLoop``'s, the wall beside that
loop's, each rank's pool bytes, the pool bytes a step gathers and one
step's gathers and keep-backs in device ms (CUDA events, all ranks
together), and each migration's pages, bytes and ms.  The summary also
goes to ``chiprun_out/mesh_dist.json``.  Exit 1 if any stream differs.

``--cpu N`` runs the same placements on N gloo ranks with qwen3-4b's
smoke model (float32, the plain path; no times), and the two-engine
placement on ``[cpu, cpu]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SMOKE_KW = dict(batch_slots=4, s_max=48, chunk=16, page=8)
SMOKE_SIZES, SMOKE_NEW = (12, 3, 25, 7, 1, 18, 30, 5), 6


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(smoke: bool, dev: torch.device):
    """qwen3-4b (full width, or its smoke model), its loop keywords and
    its requests (phase 5's on the cards)."""
    import numpy as np

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serve_loop import Request
    if smoke:
        cfg = get_config(cs.QWEN, smoke=True)
        bundle = build_model(cfg, device=dev)
        params = bundle.init(torch.Generator(device=dev).manual_seed(0))
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n),
                        max_new=SMOKE_NEW) for i, n in enumerate(SMOKE_SIZES)]
        return cfg, bundle, params, dict(SMOKE_KW), reqs
    cfg, bundle, params = cs.build_full(cs.QWEN, dev)
    _, reqs = cs.main_requests(cfg.vocab)
    return cfg, bundle, params, dict(batch_slots=cs.SLOTS, s_max=cs.S_MAX,
                                     chunk=cs.CHUNK, page=cs.PAGE), reqs


def n_pages_for(kw, cards: int) -> int:
    """The default pool (trash page + every slot's horizon) rounded up
    to a multiple of ``cards``, so that it shards over them."""
    need = 1 + kw["batch_slots"] * -(-kw["s_max"] // kw["page"])
    return -(-need // cards) * cards


def serve(loop, reqs, dev):
    _sync(dev)
    t0 = time.perf_counter()
    res = loop.run([dataclasses.replace(r, out=None) for r in reqs])
    _sync(dev)
    return res, time.perf_counter() - t0


def _pool_bytes(cache) -> int:
    if cache is None:
        return 0
    return sum(v.numel() * v.element_size() for seg in cache
               for v in seg["attn"].values() if v.dim() > 2)


def _gather_ms(loop, mesh, cache, dev):
    """Device ms of one step's gathers and keep-backs of ``cache``, a
    pool sharded over ``mesh`` (every rank of it measures together)."""
    from repro_torch.parallel.sharding import (gather_pool, keep_shard,
                                               pool_shards)
    leaves = [v for seg in cache for v in seg["attn"].values()
              if v.dim() > 2]
    lcfg = loop.bundle.cfg

    def step():
        with pool_shards(mesh):
            for v in leaves:
                for i in range(v.shape[0]):
                    keep_shard(lcfg, v[i], gather_pool(lcfg, v[i]))
    step()
    if dev.type != "cuda":
        return None
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(5):
        step()
    end.record()
    torch.cuda.synchronize(dev)
    return round(start.elapsed_time(end) / 5, 4)


def rank_cells(smoke: bool, n_pages: int):
    """One rank: both placements on rank meshes over every rank."""
    import chip_smoke as cs
    from repro_torch.launch.mesh import make_serve_meshes, rank_device
    from repro_torch.runtime.mesh_serve import ShardedPagedServeLoop
    dev = rank_device()
    if dev.type == "cuda":
        cs.fresh_tune_cache()
    cfg, bundle, params, kw, reqs = build(smoke, dev)
    out = {"device": str(dev)}
    for name, disagg in (("colocated", False), ("disaggregated", True)):
        meshes = make_serve_meshes(disaggregate=disagg, ranks=True)
        loop = ShardedPagedServeLoop(cfg, bundle, params, meshes=meshes,
                                     n_pages=n_pages, **kw)
        res, wall = serve(loop, reqs, dev)
        st = loop.stats
        cell = {"streams": res, "wall_s": round(wall, 3),
                "stats": {k: getattr(st, k) for k in cs.SERVE_COUNTERS},
                "split": dict(loop._split),
                "pool_bytes": _pool_bytes(loop.cache),
                "staging_bytes": _pool_bytes(getattr(loop, "cache_pf",
                                                     None)),
                "migrations_pages_bytes_ms": [
                    (m.pages, m.bytes, round(1e3 * m.seconds, 3))
                    for m in loop.migration_log]}
        for engine, mesh, cache in (
                ("execute", meshes.decode, loop.cache),
                ("access", meshes.prefill, getattr(loop, "cache_pf", None))):
            if not loop._split[engine] or (engine == "access"
                                           and not disagg):
                continue
            # every rank of the engine's mesh gathers its whole pool
            if mesh.member:
                cell[f"{engine}_gathered_bytes_per_step"] = \
                    _pool_bytes(cache) * mesh.size
                cell[f"{engine}_gather_keep_ms_per_step"] = _gather_ms(
                    loop, mesh, cache, dev)
        out[name] = cell
        del loop
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="rehearse on N gloo ranks with the smoke model")
    args = ap.parse_args()
    smoke = args.cpu > 0
    if not smoke and torch.cuda.device_count() < 2:
        print("mesh_dist: needs two or more CUDA cards", file=sys.stderr)
        return 1
    from repro_torch.launch.mesh import make_serve_meshes
    from repro_torch.launch.spawn import spawn
    from repro_torch.runtime.mesh_serve import ShardedPagedServeLoop
    from repro_torch.runtime.serve_loop import PagedServeLoop

    summary = {}
    if smoke:
        cards, dev = args.cpu, torch.device("cpu")
        two = [dev, dev]
        summary["card"] = "cpu (rehearsal: no device metric)"
    else:
        import chip_smoke as cs
        from repro_torch.kernels.common import build_kernels
        cards, dev = torch.cuda.device_count(), torch.device("cuda", 0)
        two = [dev, torch.device("cuda", 1)]
        summary["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        cs.fresh_tune_cache()
        summary["build_s"] = round(build_kernels(), 1)
    print(summary["card"], flush=True)
    cfg, bundle, params, kw, reqs = build(smoke, dev)
    n_pages = n_pages_for(kw, cards)
    summary.update(cards=cards, n_pages=n_pages)

    base = {}
    for name, extra in (("paged", {}), ("paged_no_reuse",
                                        {"prefix_reuse": False})):
        loop = PagedServeLoop(cfg, bundle, params, n_pages=n_pages, **kw,
                              **extra)
        res, wall = serve(loop, reqs, dev)
        base[name] = (res, wall)
        summary[name] = {"wall_s": round(wall, 3),
                         "decode_steps": loop.stats.decode_steps}
    loop = ShardedPagedServeLoop(
        cfg, bundle, params, meshes=make_serve_meshes(2, devices=two),
        n_pages=n_pages, **kw)
    res, wall = serve(loop, reqs, dev)
    want = base["paged_no_reuse"][0]
    summary["two_devices_one_process"] = {
        "devices": [str(d) for d in two], "wall_s": round(wall, 3),
        "streams_equal": sum(res[r] == want[r] for r in want),
        "migrations_pages_bytes_ms": [
            (m.pages, m.bytes, round(1e3 * m.seconds, 3))
            for m in loop.migration_log]}
    print(json.dumps({"two_devices_one_process":
                      summary["two_devices_one_process"]}), flush=True)
    del loop, params, bundle
    if not smoke:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn(rank_cells, cards, smoke, n_pages,
                  backend="gloo" if smoke else "nccl", timeout=1800)
    summary["ranks_s"] = round(time.perf_counter() - t0, 1)
    ok = summary["two_devices_one_process"]["streams_equal"] == len(want)
    for name, ref in (("colocated", "paged"),
                      ("disaggregated", "paged_no_reuse")):
        want = base[ref][0]
        cells = [r[name] for r in ranks]
        same = [sum(c["streams"][k] == want[k] for k in want) for c in cells]
        ok &= all(s == len(want) for s in same)
        ok &= all(c["stats"] == cells[0]["stats"] for c in cells)
        summary[name] = {
            "streams_equal_per_rank": same, "baseline": ref,
            "baseline_wall_s": summary[ref]["wall_s"],
            "per_rank": [{k: v for k, v in c.items() if k != "streams"}
                         for c in cells]}
        print(json.dumps({name: summary[name]}), flush=True)
    summary["ok"] = bool(ok)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mesh_dist.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({"ok": summary["ok"], "ranks_s": summary["ranks_s"]}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
