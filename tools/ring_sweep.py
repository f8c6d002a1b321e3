#!/usr/bin/env python3
"""Time the port's ring kernels on one NVIDIA card at several ring depths.

    python3 tools/ring_sweep.py

Every kernel wrapper of ``src/repro_torch`` takes an explicit ``rif``
(the depth of its shared-memory ring; ``None`` is the planned default).
This script times, at the shapes ``chip_smoke.py`` checks, ``gmm`` at
granite-moe-3b-a800m's decode and forward-step shapes (on the same
inputs as ``chip_smoke.py``), the paged decode at qwen3-4b's shape and
``flash`` at granite's forward shape; and the explicit-ring kernels of
the compiler at ``chip_smoke.py`` phase 7's card-filling shapes:
``gather_rif`` on 2^16 rows of the (151936, 2560) float32 embedding,
``ring_gather`` and ``ring_deref`` on 2^22 items over a (2^24, 32)
float32 port, and ``ring_chase`` with the binsearch_for spec over 2^22
keys in a 2^27-entry table; each at a few depths, with the cold-L2 CUDA
event timer of ``repro_torch.bench``.  If a kernel's time
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

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    timer = ColdTimer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def report(name, fn, depths):
        for rif in depths:
            print(f"sweep {name} rif={rif} ms={timer(lambda: fn(rif)):.4f}",
                  flush=True)

    sweep_model(dev, timer, gen, report)
    sweep_explicit(dev, timer, report)
    return 0


def sweep_model(dev, timer, gen, report) -> None:
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.grouped_matmul import kernel as mk
    from repro_torch.models import moe
    bf16 = torch.bfloat16
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


def sweep_explicit(dev, timer, report) -> None:
    from repro_torch.bench import binsearch_data
    from repro_torch.compile.chase import trace_chase
    from repro_torch.compile.targets import _binsearch_chase
    from repro_torch.kernels.compiled import kernel as rk
    from repro_torch.kernels.dae_gather import kernel as gk
    gen = torch.Generator(device=dev).manual_seed(71)
    depths = (1, 2, 4, 8, 16)
    n = 151_936
    table = torch.randn((n, 2560), generator=gen, device=dev)
    idx = torch.randint(0, n, (1 << 16,), generator=gen, device=dev,
                        dtype=torch.int32)
    report("gather_rif[2^16 rows of (151936, 2560) f32, chunk 64]",
           lambda rif: gk.gather_rif(table, idx, chunk=64, rif=rif), depths)
    del table
    torch.cuda.empty_cache()

    port = torch.randn((1 << 24, 32), generator=gen, device=dev)
    addrs = torch.randint(0, 1 << 24, (1 << 22,), generator=gen, device=dev,
                          dtype=torch.int32)
    report("ring_gather[2^22 of (2^24, 32) f32, chunk 64]",
           lambda rif: rk.ring_gather(port, addrs, chunk=64, rif=rif),
           depths)
    a = torch.randint(0, 1 << 24, (1 << 27, 1), generator=gen, device=dev,
                      dtype=torch.int32)
    a_addrs = torch.randint(0, 1 << 27, (1 << 22,), generator=gen,
                            device=dev, dtype=torch.int32)
    report("ring_deref[2^22 via (2^27, 1) into (2^24, 32), chunk 64, "
           "rif_a = rif_b]", lambda rif: rk.ring_deref(
               a, port, a_addrs, chunk=64, rif_a=rif, rif_b=rif), depths)
    del port, a
    torch.cuda.empty_cache()

    sorted_table, keys = binsearch_data(dev)   # 2^22 keys, 2^27 int32
    nt = sorted_table.shape[0]
    spec = _binsearch_chase({"arr": None, "keys": keys.cpu().numpy(),
                             "n": nt}, False)
    prog = trace_chase(spec.addr_fn, spec.step_fn, spec.out_fn,
                       spec.state_width, 1)
    state0 = torch.from_numpy(spec.state0.reshape(-1)).to(dev)
    report("ring_chase[binsearch_for, 2^22 keys x 27 levels]",
           lambda rif: rk.ring_chase(sorted_table.view(nt, 1), state0, prog,
                                     rif=rif, max_steps=spec.max_steps,
                                     s_width=spec.state_width), depths)


if __name__ == "__main__":
    sys.exit(main())
