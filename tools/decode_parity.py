#!/usr/bin/env python3
"""Hold this tree's split-KV decodes to other checkouts', bit for bit
and in time.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/other
    python3 tools/decode_parity.py build/other/src/repro_torch/csrc [...]

For each source directory given, builds its ``flash_decode.cu`` and
``flash_decode_paged.cu`` into ``<dir>/../lib`` and runs this tree's
wrappers on the same inputs through those libraries and through this
tree's (the split plan is this tree's for both):

* bits, at G 1-8 (the query rows a KV head; every build takes them), D
  64, 96, 128 and 192, bfloat16 and float32, three shapes (8 slots x 8
  KV heads x 1024 tokens, one request of 4096 tokens over 4 heads, 3 x
  2 x 77) and two ring depths; it exits non-zero at the first output
  whose bits differ;
* time, at ``chip_smoke.py``'s decode rows (bf16, 8 slots of up to 2048
  tokens, lengths 1, 16, 17, 2048 and four seeded; qwen3-4b's G 4 D 128
  and granite's G 3 D 64 over 8 KV heads, both decodes; one request of
  2048 tokens, paged; MLA's G 1 at 40 heads of 96 and 16 of 192,
  contiguous), with the cold-L2 CUDA event timer of ``repro_torch.bench``
  in the order other, this, this, other, and the mean of each side.

It prints the card's name and power limit; it needs a card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.bench import ColdTimer  # noqa: E402
from repro_torch.kernels.common import NVCC_FLAGS, _nvcc  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402

ENTRIES = {"flash_decode": ("flash_decode_contig", 7),
           "flash_decode_paged": ("flash_decode_paged", 8)}
PAGE = 16
# (name, B, KVH, G, D, S, kernels): chip_smoke.py's decode rows
TIMED = (("qwen3-4b G4 D128", 8, 8, 4, 128, 2048, ("contiguous", "paged")),
         ("granite G3 D64", 8, 8, 3, 64, 2048, ("contiguous", "paged")),
         ("qwen3-4b G4 D128 B 1", 1, 8, 4, 128, 2048, ("paged",)),
         ("MLA G1 KVH40 D96", 8, 40, 1, 96, 2048, ("contiguous",)),
         ("MLA G1 KVH16 D192", 8, 16, 1, 192, 2048, ("contiguous",)))


def build(src: Path):
    """Another checkout's two decode libraries, loaded with this tree's
    argument types."""
    out = src.parent / "lib"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, f"-I{src}", "-o",
                               str(out / f"lib{n}.so"), str(src / f"{n}.cu")])
             for n in ENTRIES]
    if any(p.wait() for p in procs):
        raise RuntimeError(f"nvcc failed on {src}")
    print(f"{src}: built in {time.perf_counter() - t0:.1f} s", flush=True)
    libs = {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (entry, n_ptrs) in ENTRIES.items():
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = [p] * n_ptrs + [i] * 9 + [f, i, p], i
        lib.split_decode_smem.argtypes = [i] * 7
        lib.split_decode_smem.restype = ctypes.c_longlong
        lib.split_decode_partial.argtypes = [i, i]
        lib.split_decode_partial.restype = ctypes.c_longlong
        lib.repro_smem_optin.argtypes, lib.repro_smem_optin.restype = [i], i
        libs[name] = lib
    return libs


class Using:
    """Route this tree's wrappers through ``libs`` (None: this tree's)."""
    mine = (fk._lib, fk._paged_lib)

    def __init__(self, libs):
        self.libs = libs

    def __enter__(self):
        if self.libs is not None:
            fk._lib = lambda: self.libs["flash_decode"]
            fk._paged_lib = lambda: self.libs["flash_decode_paged"]

    def __exit__(self, *exc):
        fk._lib, fk._paged_lib = self.mine


def inputs(b, kvh, g, d, s, dtype, gen, dev):
    """q, a contiguous cache, a page pool and its shuffled table, and
    lengths (the first 4 of 1, 16, 17, S where B allows)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    npb = -(-s // PAGE)
    table = (torch.randperm(b * npb, generator=gen, device=dev) + 1).to(
        torch.int32).reshape(b, npb)
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[:min(b, 4)] = torch.tensor([s, 1, PAGE, PAGE + 1],
                                       dtype=torch.int32)[:min(b, 4)]
    return (randn(b, kvh, g, d), randn(b, kvh, s, d), randn(b, kvh, s, d),
            randn(1 + b * npb, kvh, PAGE, d), randn(1 + b * npb, kvh, PAGE, d),
            table, lengths)


def call(kind, q, kc, vc, kp, vp, table, lengths, rif=None):
    scale = q.shape[3] ** -0.5
    if kind == "contiguous":
        return fk.flash_decode(q, kc, vc, lengths, scale=scale, rif=rif)
    return fk.flash_decode_paged(q, kp, vp, table, lengths, scale=scale,
                                 rif=rif)


def bits(other, dev) -> int:
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        view = torch.int16 if dtype == torch.bfloat16 else torch.int32
        for g in range(1, 9):
            for d in (64, 96, 128, 192):
                for b, kvh, s in ((8, 8, 1024), (1, 4, 4096), (3, 2, 77)):
                    gen = torch.Generator(device=dev).manual_seed(
                        g * 1000 + d + s)
                    args = inputs(b, kvh, g, d, s, dtype, gen, dev)
                    out = {}
                    for side in (other, None):
                        with Using(side):
                            for kind in ("contiguous", "paged"):
                                for rif in (None, 1):
                                    out[side is None, kind, rif] = call(
                                        kind, *args, rif=rif)
                    torch.cuda.synchronize()
                    for kind in ("contiguous", "paged"):
                        for rif in (None, 1):
                            a = out[False, kind, rif].view(view)
                            if not torch.equal(a, out[True, kind, rif].view(
                                    view)):
                                raise SystemExit(
                                    f"differ: {dtype} G {g} D {d} B {b} KVH "
                                    f"{kvh} S {s} {kind} rif {rif}")
                            n += 1
    return n


def main() -> int:
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    timer = ColdTimer(dev)
    for src in sys.argv[1:]:
        other = build(Path(src))
        print(f"{src}: {bits(other, dev)} outputs bit-identical, G 1-8",
              flush=True)
        for name, b, kvh, g, d, s, kinds in TIMED:
            gen = torch.Generator(device=dev).manual_seed(2)
            args = inputs(b, kvh, g, d, s, torch.bfloat16, gen, dev)
            for kind in kinds:
                ms = {True: [], False: []}
                for side in (other, None, None, other):
                    with Using(side):
                        ms[side is None].append(timer(
                            lambda: call(kind, *args)))
                print(f"{src}: {kind} [{name}] ms other "
                      f"{' '.join(f'{t:.4f}' for t in ms[False])}, this "
                      f"{' '.join(f'{t:.4f}' for t in ms[True])}; mean "
                      f"other {sum(ms[False]) / 2:.4f} this "
                      f"{sum(ms[True]) / 2:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
