#!/usr/bin/env python3
"""Where a full-width train step's device time goes.

    python3 tools/train_profile.py [--layers N] [--steps K]

Builds granite-moe-3b-a800m as ``chip_smoke.py``'s phase 10 trains it
(full width, float32 parameters and AdamW state, bf16 compute,
``kernel_mode="ref"``, 4 x 1024 tokens of ``SyntheticLM``), runs two
warm steps, then traces K steps (default 1) of ``make_train_step`` with
``torch.profiler``.  It prints the step's wall, the device busy time
and idle share, the number of device operations, the device time of the
optimizer (its range) against the rest, and the 25 device operations
that take the most time (name, calls, ms) and the same grouped into
classes (matrix products, attention softmax, MoE dispatch, optimizer
elementwise, the rest).  ``--layers`` cuts the depth for a quicker look.
It prints the card's name and power limit; it needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

CLASSES = (("matrix products", r"gemm|gemv|cutlass|sm90_xmma|nvjet|Kernel2"
            r"|dot_kernel|splitK"),
           ("softmax / elementwise math", r"exp|softmax|where|masked"),
           ("reductions", r"reduce|sum|max|norm"),
           ("index, scatter, sort", r"index|scatter|gather|sort|radix"
            r"|cumsum|scan|put"),
           ("copies and casts", r"copy|cast|Memcpy|Memset|fill"),
           ("other elementwise", r"elementwise|vectorized|unrolled"))


def classify(name: str) -> str:
    for cls, pat in CLASSES:
        if re.search(pat, name, re.I):
            return cls
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args()
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("granite-moe-3b-a800m", kernel_mode="ref")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                   dtype=cfg.pdtype)

    class Ranged:
        def __init__(self, opt):
            self.opt = opt

        def update(self, grads, state, p):
            with record_function("optimizer"):
                return self.opt.update(grads, state, p)

    opt = AdamW(lr=3e-4)
    state = opt.init(params)
    step = make_train_step(cfg, Ranged(opt))
    batch = SyntheticLM(cfg.vocab, 1024, 4).batch_at(0)
    for _ in range(2):
        params, state, m = step(params, state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    # the device side of the optimizer's range is an annotation that
    # spans its kernels, not work of its own
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name != "optimizer"]
    busy = sum(e.device_time_total for e in events) / 1e3 / args.steps
    opt_ms = 0.0
    for e in prof.events():
        if e.name == "optimizer" and e.device_type != \
                torch.autograd.DeviceType.CUDA:
            opt_ms += e.device_time_total / 1e3
    opt_ms /= args.steps
    by_name = defaultdict(lambda: [0, 0.0])
    by_class = defaultdict(float)
    for e in events:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.device_time_total / 1e3
        by_class[classify(e.name)] += e.device_time_total / 1e3
    idle = 100 * (1 - busy / 1e3 / wall)
    print(f"layers {cfg.n_layers}; step wall {wall * 1e3:.1f} ms (traced); "
          f"device busy {busy:.1f} ms, idle {idle:.1f} %; "
          f"{len(events) // args.steps} device operations a step; "
          f"optimizer range {opt_ms:.1f} ms of device time ({card})")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  class {cls}: {ms / args.steps:.1f} ms")
    for name, (n, ms) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:25]:
        print(f"  {ms / args.steps:9.2f} ms {n // args.steps:6d} x "
              f"{name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
