#!/usr/bin/env python3
"""Time the port's ring kernels on one NVIDIA card at several ring depths.

    python3 tools/ring_sweep.py

Every kernel wrapper of ``src/repro_torch`` takes an explicit ``rif``
(the depth of its shared-memory ring; ``None`` is the planned default).
This script times, at the shapes ``chip_smoke.py`` checks, ``gmm`` at
granite-moe-3b-a800m's decode and forward-step shapes (on the same
inputs as ``chip_smoke.py``), the paged decode at qwen3-4b's shape and
``flash`` at granite's forward shape, each at a few depths, with the
cold-L2 CUDA event timer of ``repro_torch.bench``.  If a kernel's time
falls with the depth, memory latency not covered by the ring sets it;
if it stays flat, a fixed cost per ring stage does.  It prints the
card's name and power limit and one line per (kernel, depth); it needs
a card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    if not torch.cuda.is_available():
        print("ring_sweep: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.bench import ColdTimer
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.grouped_matmul import kernel as mk
    from repro_torch.models import moe

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    timer = ColdTimer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def report(name, fn, depths):
        for rif in depths:
            print(f"sweep {name} rif={rif} ms={timer(lambda: fn(rif)):.4f}",
                  flush=True)

    e, k, d, f, bt = 40, 8, 1536, 512, 128
    for tokens, case in ((8, "decode 8 tokens"), (4096, "lm_apply 4096")):
        # the inputs of chip_smoke.py's check_gmm, drawn in its order
        g2 = torch.Generator(device=dev).manual_seed(tokens)
        experts = torch.rand((tokens, e), generator=g2, device=dev).topk(
            k, dim=-1).indices.to(torch.int32)
        _, se, stok, counts, pos = moe.sort_pairs(experts, e)
        tp, starts, be, rows = moe.block_layout(counts, tokens * k, bt)
        x = torch.randn((tokens, d), generator=g2, device=dev).to(bf16)
        xs = x.new_zeros((tp, d))
        xs[starts[se] + pos] = x[stok]
        w = (torch.randn((e, d, f), generator=g2, device=dev) * d ** -0.5
             ).to(bf16)
        report(f"gmm[{case}]", lambda rif: mk.gmm(
            xs, w, be, bt=bt, block_rows=rows, rif=rif),
            (None, 1, 2, 4, 7, 15, None))

    b, kvh, g, hd, page, s = 8, 8, 4, 128, 16, 2048
    npb = s // page
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(bf16)
    kp = torch.randn((1 + b * npb, kvh, page, hd), generator=gen,
                     device=dev).to(bf16)
    vp = torch.randn_like(kp)
    table = (torch.randperm(b * npb, generator=gen, device=dev) + 1).to(
        torch.int32).reshape(b, npb)
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    report("flash_decode_paged[qwen3 G4 D128, 8 x 2048]", lambda rif:
           fk.flash_decode_paged(q, kp, vp, table, lengths,
                                 scale=hd ** -0.5, rif=rif), (1, 2, 4, 8, 16))

    qf = torch.randn((2, 24, 2048, 64), generator=gen, device=dev).to(bf16)
    kf = torch.randn((2, 8, 2048, 64), generator=gen, device=dev).to(bf16)
    vf = torch.randn_like(kf)
    report("flash[granite H24 D64 S2048]", lambda rif: fk.flash(
        qf, kf, vf, causal=True, window=None, scale=0.125, rif=rif),
        (1, 2, 3, 6))
    return 0


if __name__ == "__main__":
    sys.exit(main())
