#!/usr/bin/env python3
"""Time disaggregated serving against the paged loop it must equal, on
one card, and the page migration's host hop alone.

    python3 tools/mesh_ab.py

Builds qwen3-4b at full width (``chip_smoke.py``'s phase 5 build and
requests, an empty tune cache), warms both loops on two short requests,
then serves phase 5's 8 requests in the order ``PagedServeLoop
(prefix_reuse=False)``, ``ShardedPagedServeLoop`` on ``[cuda, cuda]``,
the sharded loop, the paged loop, and prints each run's wall, TTFT p50
and p95 and migration seconds.  Last it copies the K pages of a
44-page migration (36 x 44 x 8 x 16 x 128 bf16, 49.5 MiB) to the host
and back, twice through pageable memory and twice through pinned memory
(its allocation timed with the copy).  It prints the card's name and
power limit; it needs a card.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_ab: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.common import build_kernels
    from repro_torch.launch.mesh import make_serve_meshes
    from repro_torch.runtime.mesh_serve import ShardedPagedServeLoop
    from repro_torch.runtime.serve_loop import PagedServeLoop

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cs.fresh_tune_cache()
    print("build", build_kernels(), flush=True)
    dev = torch.device("cuda")
    cfg, bundle, params = cs.build_full(cs.QWEN, dev)
    _, reqs = cs.main_requests(cfg.vocab)
    kw = dict(batch_slots=cs.SLOTS, s_max=cs.S_MAX, chunk=cs.CHUNK,
              page=cs.PAGE)

    def paged():
        return PagedServeLoop(cfg, bundle, params, prefix_reuse=False, **kw)

    def disagg():
        return ShardedPagedServeLoop(
            cfg, bundle, params,
            meshes=make_serve_meshes(2, devices=[dev, dev]), **kw)

    for make in (paged, disagg):
        cs.serve(make(), [dataclasses.replace(r, out=None, max_new=2)
                          for r in reqs[:2]])
    for name, make in (("paged", paged), ("disagg", disagg),
                       ("disagg", disagg), ("paged", paged)):
        torch.cuda.empty_cache()
        loop = make()
        _, wall = cs.serve(loop, [dataclasses.replace(r, out=None)
                                  for r in reqs])
        mig = sum(m.seconds for m in getattr(loop, "migration_log", []))
        print(name, json.dumps({
            "wall_s": wall, "ttft_ms_p50_p95": cs._ttft_ms(loop.stats, reqs),
            "migration_s": mig}), flush=True)

    x = torch.randn(36, 44, 8, 16, 128, device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    for pinned in (False, True):
        for _ in range(2):
            t0 = time.perf_counter()
            if pinned:
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x)
            else:
                h = x.cpu()
            t1 = time.perf_counter()
            h.to(dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            print("hop", "pinned" if pinned else "pageable", json.dumps({
                "d2h_ms": 1e3 * (t1 - t0), "h2d_ms": 1e3 * (t2 - t1),
                "bytes": x.numel() * x.element_size()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
