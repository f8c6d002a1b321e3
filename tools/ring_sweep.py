#!/usr/bin/env python3
"""Time the port's ring kernels on one NVIDIA card at several ring depths.

    python3 tools/ring_sweep.py

Every kernel wrapper of ``src/repro_torch`` takes an explicit ``rif``
(the depth of its shared-memory ring; ``None`` is the planned default).
This script times, at the shapes ``chip_smoke.py`` checks, ``gmm`` at
granite-moe-3b-a800m's decode, prefill-chunk and forward-step shapes (on
the same inputs as ``chip_smoke.py``) by ring depth, then by column
tile (through the wrapper's private ``_bn``), the paged decode at qwen3-4b's shape for
8 slots and for one request (its ``rif`` is the K+V pages in flight per
CTA: 4 warps x 1 to 4 ring stages), then its split size (pages per
split, through the C entry point, for the 8-slot shape at full and at
``chip_smoke.py``'s mixed lengths and for one request); the contiguous
decode at the same shape by tokens per block, blocks in flight and
blocks per split; ``flash`` at granite's, qwen3-4b's, minicpm3-4b's and
deepseek-v2-lite-16b's forward widths by key block and ring depth, then
beside SDPA at 2048 and 8192 tokens; and the explicit-ring kernels of
the compiler at ``chip_smoke.py`` phase 7's card-filling shapes:
``gather_rif`` on 2^16 rows of the (151936, 2560) float32 embedding by
depth and by the bulk body's CTA count (through ``ring_rows``'s private
``_ctas``), ``ring_gather`` (also at 16-byte rows) and ``ring_deref`` on 2^22 items over a (2^24, 32) float32 port, and
``ring_chase`` with the binsearch_for spec over 2^22 keys in a
2^27-entry table (its ``rif`` is the items each thread keeps in
flight); each at a few depths, with the cold-L2 CUDA event timer of
``repro_torch.bench``.  If a kernel's time falls with the depth, memory
latency not covered by the ring sets it; if it stays flat, a fixed cost
per ring stage does.  It prints the card's name and power limit and one
line per (kernel, depth); it needs a card.

    python3 tools/ring_sweep.py gmm explicit

runs only the named parts: ``gmm``, ``attention`` (the decodes and
``flash``), ``explicit`` (the explicit-ring kernels), ``merge``
(``merge_tiles`` on ``chip_smoke.py``'s merge of two 2^23 int32 runs by
ring stages, then the same tiles from random starts, which take its
per-tile path), ``gather`` (``gather_rows`` at the main paths'
embedding shapes and at 32 KB rows, beside ``index_select``, a
device-to-device copy of the same bytes and an empty kernel), ``search``
and ``deref``:

* ``search`` on ``chip_smoke.py`` phase 6's table and keys: first the
  cost of a random read on the card, 2^22 reads one a key at the key's
  block by unit size (32 to 512 bytes), then 1 to 4 dependent reads a
  key at each size (``tools/search_variants.cu``'s ``calib_reads``);
  then the package's unit search by ``chunk`` and ``rif`` at its 64-byte
  unit and, built from the same kernel in ``search_variants.cu``
  (``search_units``), at 32- and 128-byte units; and the other design,
  the whole block by bulk copy (``search_bulk``), by ring slots and
  persistent CTAs an SM, each checked against the plain version;
* ``deref`` on phase 7's shapes (2^22 items, a (2^27, 1) int32 index
  port, a (2^24, 32) float32 data port): the index hop alone
  (``index_select`` of 2^22 words of the index port), ``ring_gather`` of
  the same rows, then ``ring_deref`` by ``rif_a`` and CTAs an SM (the
  private ``_ctas``), each checked against the plain version.
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

    known = {"gmm", "attention", "explicit", "merge", "gather", "search",
             "deref"}
    parts = set(sys.argv[1:]) or known
    unknown = parts - known
    if unknown:
        print(f"ring_sweep: unknown parts {sorted(unknown)}", file=sys.stderr)
        return 2
    if "gmm" in parts:
        sweep_gmm(dev, timer, report)
    if "attention" in parts:
        sweep_attention(dev, timer, gen, report)
    if "explicit" in parts:
        sweep_explicit(dev, timer, report)
    if "merge" in parts:
        sweep_merge(dev, timer, report)
    if "gather" in parts:
        sweep_gather(dev, timer)
    if "search" in parts:
        sweep_search(dev, timer)
    if "deref" in parts:
        sweep_deref(dev, timer)
    return 0


def sweep_gmm(dev, timer, report) -> None:
    from repro_torch.kernels.grouped_matmul import kernel as mk
    from repro_torch.models import moe
    bf16 = torch.bfloat16
    e, k, bt = 40, 8, 128
    for tokens, case, d, f in (
            (1, "decode 1 token", 1536, 512),
            (8, "decode 8 tokens", 1536, 512),
            (256, "chunk 256 tokens", 1536, 512),
            (4096, "lm_apply 4096", 1536, 512),
            (8, "decode 8 tokens, down D512 F1536", 512, 1536),
            (256, "chunk 256 tokens, down D512 F1536", 512, 1536)):
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
        # the ring depth at the default tile, then the tile width at the
        # planned depth
        report(f"gmm[{case}]", lambda rif: mk.gmm(
            xs, w, be, bt=bt, block_rows=rows, rif=rif),
            (None, 2, 3, 4, None))
        for bn in (128, 256):
            ms = timer(lambda: mk.gmm(xs, w, be, bt=bt, block_rows=rows,
                                      _bn=bn))
            print(f"sweep gmm[{case}] bn={bn} ms={ms:.4f}", flush=True)


def sweep_attention(dev, timer, gen, report) -> None:
    from repro_torch.kernels.flash_attention import kernel as fk
    bf16 = torch.bfloat16
    kvh, g, hd, page, s = 8, 4, 128, 16, 2048
    npb = s // page
    for b in (8, 1):
        q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(bf16)
        kp = torch.randn((1 + b * npb, kvh, page, hd), generator=gen,
                         device=dev).to(bf16)
        vp = torch.randn_like(kp)
        table = (torch.randperm(b * npb, generator=gen, device=dev) + 1).to(
            torch.int32).reshape(b, npb)
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
        report(f"flash_decode_paged[qwen3 G4 D128, {b} x 2048]",
               lambda rif: fk.flash_decode_paged(
                   q, kp, vp, table, lengths, scale=hd ** -0.5, rif=rif),
               (None, 4, 8, 12, 16))

    sweep_paged_splits(dev, timer)
    sweep_contig(dev, timer, report)
    sweep_flash(dev, timer, gen, report)
    sweep_flash_lengths(dev, timer, gen)


def sweep_flash(dev, timer, gen, report) -> None:
    """``flash`` at granite's (D 64), qwen3-4b's (D 128), minicpm3-4b's
    (D 96) and deepseek-v2-lite-16b's (D 192) forward widths, B 2,
    S 2048, causal:
    every key block the source instantiates at each ring depth that fits
    (``rif``: K+V stages)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    lib = fk._prefill_lib()
    for h, kvh, d, case in ((24, 8, 64, "granite H24 KVH8 D64"),
                            (32, 8, 128, "qwen3 H32 KVH8 D128"),
                            (40, 40, 96, "minicpm3 H40 KVH40 D96"),
                            (16, 16, 192, "deepseek H16 KVH16 D192")):
        q = torch.randn((2, h, 2048, d), generator=gen, device=dev).to(
            torch.bfloat16)
        k = torch.randn((2, kvh, 2048, d), generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn_like(k)
        for bk in fk.prefill_block_keys(lib, d, True):
            stage = lib.flash_prefill_stage_bytes(d, bk, 1)
            fits = ((lib.repro_smem_optin(0)
                     - lib.flash_prefill_extra_bytes(d, 1)) // stage)
            report(f"flash[{case} S2048, bk {bk}]",
                   lambda rif: fk.flash(q, k, v, causal=True, window=None,
                                        scale=d ** -0.5, rif=rif, bk=bk),
                   (None, *range(1, min(fits, 6) + 1)))


def sweep_flash_lengths(dev, timer, gen) -> None:
    """``flash`` and SDPA at granite's (D 64) and qwen3-4b's (D 128)
    widths, B 2, causal, S 2048 and 8192, with the useful rate: visible
    (row, col) pairs x 4 x D flops over the time.  At long S a CTA's
    start, its first tiles' loads and the causal tail weigh little, so
    the ratio of the two is the ratio of their inner loops."""
    from repro_torch.kernels.flash_attention import kernel as fk
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for h, kvh, d in ((24, 8, 64), (32, 8, 128)):
        for s in (2048, 8192):
            q = torch.randn((2, h, s, d), generator=gen, device=dev).to(
                torch.bfloat16)
            k = torch.randn((2, kvh, s, d), generator=gen, device=dev).to(
                torch.bfloat16)
            v = torch.randn_like(k)
            flops = 4 * 2 * h * s * (s + 1) / 2 * d
            ms = timer(lambda: fk.flash(q, k, v, causal=True, window=None,
                                        scale=d ** -0.5))
            ms_lib = timer(lambda: sdpa(q, k, v, is_causal=True,
                                        enable_gqa=True))
            print(f"sweep flash lengths[H{h} KVH{kvh} D{d} S{s}] ms={ms:.4f} "
                  f"tflops={flops / ms / 1e9:.0f} sdpa_ms={ms_lib:.4f} "
                  f"sdpa_tflops={flops / ms_lib / 1e9:.0f}", flush=True)


def sweep_contig(dev, timer, report) -> None:
    """The contiguous decode at qwen3-4b's shape (8 slots x 8 KV heads,
    G 4, D 128, S 2048, bf16) at the full length and at ``chip_smoke.py``'s
    mixed lengths: by tokens per block (``bk``, splits from the rule),
    then by blocks per split at the default ``bk`` (through the C entry
    point, one ring stage a warp)."""
    from repro_torch.kernels.common import cdiv, stream_ptr
    from repro_torch.kernels.flash_attention import kernel as fk
    lib = fk._lib()
    b, kvh, g, d, s = 8, 8, 4, 128, 2048
    for mixed in (False, True):
        gen = torch.Generator(device=dev).manual_seed(2)
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
        if mixed:      # chip_smoke.py's: 1, 16, 17, 2048 and seeded ones
            lengths = torch.randint(1, s + 1, (b,), generator=gen,
                                    device=dev, dtype=torch.int32)
            lengths[:4] = torch.tensor([1, 16, 17, s], dtype=torch.int32)
        q = torch.randn((b, kvh, g, d), generator=gen, device=dev).to(
            torch.bfloat16)
        kc = torch.randn((b, kvh, s, d), generator=gen, device=dev).to(
            torch.bfloat16)
        vc = torch.randn_like(kc)
        case = f"G4 D128, {b} x {'mixed' if mixed else s}"
        for bk in (16, 32, 64):
            ms = timer(lambda: fk.flash_decode(q, kc, vc, lengths,
                                               scale=d ** -0.5, bk=bk))
            print(f"sweep flash_decode[{case}] bk={bk} ms={ms:.4f}",
                  flush=True)
        report(f"flash_decode[{case}, bk {fk.DEFAULT_BK}]",
               lambda rif: fk.flash_decode(q, kc, vc, lengths,
                                           scale=d ** -0.5, rif=rif),
               (None, 4, 8))
        want = fk.decode_plain(q, kc, vc, lengths, scale=d ** -0.5)
        out = torch.empty_like(q)
        counters = torch.zeros(b * kvh, dtype=torch.int32, device=dev)
        bk = fk.DEFAULT_BK
        nblk = cdiv(s, bk)
        for pps in (4, 8, 16, 32, nblk):
            nsplit = cdiv(nblk, pps)
            part = torch.empty((b, kvh, nsplit,
                                lib.split_decode_partial(g, d)),
                               dtype=torch.float32, device=dev)

            def call():
                status = lib.flash_decode_contig(
                    q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                    lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
                    counters.data_ptr(), b, kvh, g, d, s, bk, pps, nsplit,
                    1, kc.stride(0), d ** -0.5, 1, stream_ptr(dev))
                if status:
                    raise RuntimeError(f"flash_decode_contig: {status}")
            call()
            err = float((out.float() - want.float()).abs().max())
            print(f"sweep flash_decode splits[{case}, bk {bk}] pps={pps} "
                  f"nsplit={nsplit} ms={timer(call):.4f} "
                  f"max_abs_err={err:.2e}", flush=True)


def sweep_paged_splits(dev, timer) -> None:
    """The paged decode at other split sizes than ``paged_splits`` picks,
    one ring stage a warp: few large splits leave SMs idle and run long
    chains of pages per warp, many small ones cost merges."""
    from repro_torch.kernels.common import cdiv, stream_ptr
    from repro_torch.kernels.flash_attention import kernel as fk
    lib = fk._paged_lib()
    kvh, g, d, page, s = 8, 4, 128, 16, 2048
    npb = s // page
    for b, mixed, sizes in ((8, False, (4, 8, 15, 26, 64, 128)),
                            (8, True, (4, 8, 15, 26, 64, 128)),
                            (1, False, (4, 8, 32, 128))):
        gen = torch.Generator(device=dev).manual_seed(2)
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
        if mixed:      # chip_smoke.py's: 1, 16, 17, 2048 and seeded ones
            lengths = torch.randint(1, s + 1, (b,), generator=gen,
                                    device=dev, dtype=torch.int32)
            lengths[:4] = torch.tensor([1, page, page + 1, s],
                                       dtype=torch.int32)
        q = torch.randn((b, kvh, g, d), generator=gen, device=dev).to(
            torch.bfloat16)
        kp = torch.randn((1 + b * npb, kvh, page, d), generator=gen,
                         device=dev).to(torch.bfloat16)
        vp = torch.randn_like(kp)
        table = (torch.randperm(b * npb, generator=gen, device=dev) + 1).to(
            torch.int32).reshape(b, npb)
        want = fk.decode_paged_plain(q, kp, vp, table, lengths,
                                     scale=d ** -0.5)
        out = torch.empty_like(q)
        counters = torch.zeros(b * kvh, dtype=torch.int32, device=dev)
        for pps in sizes:
            nsplit = cdiv(npb, pps)
            part = torch.empty((b, kvh, nsplit,
                                lib.split_decode_partial(g, d)),
                               dtype=torch.float32, device=dev)

            def call():
                status = lib.flash_decode_paged(
                    q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                    part.data_ptr(), counters.data_ptr(), b, kvh, g, d, npb,
                    page, pps, nsplit, 1, d ** -0.5, 1, stream_ptr(dev))
                if status:
                    raise RuntimeError(f"flash_decode_paged: {status}")
            call()
            err = float((out.float() - want.float()).abs().max())
            print(f"sweep flash_decode_paged splits[G4 D128, {b} x "
                  f"{'mixed' if mixed else 2048}] pps={pps} nsplit={nsplit} "
                  f"ms={timer(call):.4f} max_abs_err={err:.2e}", flush=True)


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
    # the bulk body (its CTAs from bulk_ctas) by depth, then at the
    # planned depth by CTA count (0: one CTA a chunk)
    report("gather_rif[2^16 rows of (151936, 2560) f32, chunk 64]",
           lambda rif: gk.gather_rif(table, idx, chunk=64, rif=rif), depths)
    for ctas in (0, 132, 264, 528, 1056):
        ms = timer(lambda: gk.ring_rows(table, idx, 64, 2, (torch.float32,),
                                        _ctas=ctas))
        print(f"sweep gather_rif[2^16 rows of (151936, 2560) f32, chunk 64, "
              f"rif 2] ctas={ctas} ms={ms:.4f}", flush=True)
    del table
    torch.cuda.empty_cache()

    port = torch.randn((1 << 24, 32), generator=gen, device=dev)
    addrs = torch.randint(0, 1 << 24, (1 << 22,), generator=gen, device=dev,
                          dtype=torch.int32)
    report("ring_gather[2^22 of (2^24, 32) f32, chunk 64]",
           lambda rif: rk.ring_gather(port, addrs, chunk=64, rif=rif),
           depths)
    # 16-byte rows: a 4-wide view of the same port
    narrow = port.view(-1, 4)[: 1 << 24]
    report("ring_gather[2^22 of (2^24, 4) f32, chunk 64]",
           lambda rif: rk.ring_gather(narrow, addrs, chunk=64, rif=rif),
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
                                     s_width=spec.state_width),
           (1, 2, 3, 4, 6, 8, 9, 12, 16))


def sweep_merge(dev, timer, report) -> None:
    from repro_torch.kernels.dae_merge import kernel as mgk
    from repro_torch.kernels.dae_merge.ops import merge_path_splits
    gen = torch.Generator(device=dev).manual_seed(64)
    half, tile = 1 << 23, 256
    a, b = (torch.sort(torch.randint(0, 1 << 26, (half,), generator=gen,
                                     device=dev, dtype=torch.int32)).values
            for _ in range(2))
    n_tiles = 2 * half // tile
    ia, ib = merge_path_splits(a, b, tile, n_tiles)
    ea, eb = torch.full_like(ia, half), torch.full_like(ib, half)
    report("merge_tiles[two 2^23 int32 runs, tile 256]",
           lambda rif: mgk.merge_tiles(a, b, ia, ea, ib, eb, 2 * half,
                                       tile=tile, rif=rif), (1, 2, 3, 4))
    # span size through the C entry point (the wrapper's span_tiles rule
    # gives 16 at tile 256), and a copy of the output's bytes
    from repro_torch.kernels.common import check_status, stream_ptr
    lib, out = mgk._lib(), torch.empty(2 * half, dtype=torch.int32,
                                       device=dev)
    for span in (8, 16, 32):
        for stages in (2, 3):
            def call():
                check_status(lib, lib.dae_merge_tiles(
                    a.data_ptr(), b.data_ptr(), ia.data_ptr(), ea.data_ptr(),
                    ib.data_ptr(), eb.data_ptr(), out.data_ptr(), 2 * half,
                    n_tiles, tile, span, stages,
                    mgk.stage_bytes(tile, span), 0, stream_ptr(dev)),
                    "dae_merge_tiles")
            print(f"sweep merge_tiles[two 2^23 int32 runs, tile 256] span="
                  f"{span} stages={stages} ms={timer(call):.4f}", flush=True)
    ab = torch.cat([a, b])
    print(f"sweep merge_tiles[two 2^23 int32 runs] copy of the same 2^24 "
          f"int32 ms={timer(lambda: out.copy_(ab)):.4f}", flush=True)
    ra, rb = (torch.randint(0, half - tile, (n_tiles,), generator=gen,
                            device=dev, dtype=torch.int32) for _ in range(2))
    report("merge_tiles[the same tiles from random starts: per-tile path]",
           lambda rif: mgk.merge_tiles(a, b, ra, ea, rb, eb, 2 * half,
                                       tile=tile, rif=rif), (2, 4))


def sweep_gather(dev, timer) -> None:
    from repro_torch.kernels.dae_gather import kernel as gk
    gen = torch.Generator(device=dev).manual_seed(1)
    for n, d, ms in ((151_936, 2560, (8, 256)),
                     (49_155, 1536, (8, 256, 4096)),
                     (32_768, 8192, (8, 256))):
        table = torch.randn((n, d), generator=gen, device=dev)
        for m in ms:
            idx = torch.randint(0, n, (m,), generator=gen, device=dev,
                                dtype=torch.int32)
            src, dst = table[:m].clone(), torch.empty((m, d), device=dev)
            for name, fn in (
                    ("gather_rows", lambda: gk.gather_rows(table, idx)),
                    ("index_select",
                     lambda: torch.index_select(table, 0, idx)),
                    ("copy of the same bytes", lambda: dst.copy_(src)),
                    ("empty kernel", lambda: torch.cuda._sleep(0))):
                print(f"sweep gather[({n}, {d}) f32, M {m}] {name} "
                      f"ms={timer(fn):.4f}", flush=True)
        del table


def _variants():
    """tools/search_variants.cu, built at first use like a chase kernel."""
    import ctypes
    import hashlib
    from repro_torch.kernels.common import CSRC, NVCC_FLAGS, load_generated
    src = (Path(__file__).resolve().parent / "search_variants.cu").read_text()
    headers = "".join(h.read_text() for h in sorted(CSRC.glob("*.cuh")))
    headers += (CSRC / "dae_chase.cu").read_text()
    digest = hashlib.sha256((src + headers + " ".join(NVCC_FLAGS)).encode())
    lib = load_generated(f"search_variants_{digest.hexdigest()[:16]}", src)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.calib_random_reads.argtypes = [p, p, p, ll, i, ll, i, i, p]
    lib.calib_random_reads.restype = i
    lib.search_bulk_blocks.argtypes = [p, p, p, p, ll, i, ll, ll, i, i, ll,
                                       i, p]
    lib.search_bulk_blocks.restype = i
    lib.search_unit_blocks.argtypes = [p, p, p, p, ll, i, ll, ll, i, i, i,
                                       i, i, p]
    lib.search_unit_blocks.restype = i
    return lib


def sweep_search(dev, timer) -> None:
    from repro_torch.bench import binsearch_data
    from repro_torch.kernels.common import check_status, sm_count, stream_ptr
    from repro_torch.kernels.dae_chase import kernel as ck
    lib = _variants()
    table, keys = binsearch_data(dev)
    n, m, block = table.shape[0], keys.shape[0], 128
    tiles = table.view(-1, block)
    blk = (torch.searchsorted(tiles[:, 0].contiguous(), keys, right=True)
           - 1).clamp_(0, tiles.shape[0] - 1).to(torch.int32)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    case = f"{m} keys, ({tiles.shape[0]}, {block}) int32"
    for unit in (32, 64, 128, 256, 512):
        for depth in (1, 2, 3, 4):
            def call():
                check_status(lib, lib.calib_random_reads(
                    tiles.data_ptr(), blk.data_ptr(), out.data_ptr(),
                    tiles.shape[0], block, m, unit, depth, stream_ptr(dev)),
                    "calib_random_reads")
            ms = timer(call)
            print(f"sweep search calib[{case}] unit={unit} depth={depth} "
                  f"ms={ms:.4f} reads_per_us={m * depth / ms / 1e3:.0f} "
                  f"GB_per_s={m * depth * unit / ms / 1e6:.0f}", flush=True)
    want = ck.searchsorted_blocks_plain(tiles, blk, keys, n)
    for chunk in (64, 256, 1024):
        for rif in (1, 2, 4):
            got = ck.searchsorted_blocks(tiles, blk, keys, n, chunk=chunk,
                                         rif=rif)
            assert torch.equal(got, want), (chunk, rif)
            ms = timer(lambda: ck.searchsorted_blocks(
                tiles, blk, keys, n, chunk=chunk, rif=rif))
            plan = ck.search_plan(block, m, chunk, rif)
            print(f"sweep search probe[{case}] unit={ck.SEARCH_UNIT_BYTES} "
                  f"chunk={chunk} rif={rif} kpt={plan.kpt} "
                  f"levels={plan.levels} ms={ms:.4f}", flush=True)
    for unit in (32, 128):
        # the kernel at another unit: as the package plans, with the
        # unit's levels and keys a lane group in flight
        levels = (block * 4 // unit).bit_length()
        for chunk in (64, 256, 1024):
            for rif in (1, 2, 4):
                kpt = min(rif, -(-chunk // (512 // unit)))
                kpt = 1 << (kpt.bit_length() - 1)

                def units():
                    check_status(lib, lib.search_unit_blocks(
                        tiles.data_ptr(), blk.data_ptr(), keys.data_ptr(),
                        out.data_ptr(), tiles.shape[0], block, m, n, chunk,
                        kpt, unit, levels, 0, stream_ptr(dev)),
                        "search_unit_blocks")
                out.zero_()
                units()
                assert torch.equal(out, want), (unit, chunk, rif)
                print(f"sweep search probe[{case}] unit={unit} "
                      f"chunk={chunk} rif={rif} kpt={kpt} levels={levels} "
                      f"ms={timer(units):.4f}", flush=True)
    sms = sm_count(dev)
    for slots in (4, 8, 16, 32):
        for per_sm in (1, 2, 4, 8):
            def bulk():
                check_status(lib, lib.search_bulk_blocks(
                    tiles.data_ptr(), blk.data_ptr(), keys.data_ptr(),
                    out.data_ptr(), tiles.shape[0], block, m, n, 64, slots,
                    per_sm * sms, 0, stream_ptr(dev)), "search_bulk_blocks")
            out.zero_()
            bulk()
            assert torch.equal(out, want), (slots, per_sm)
            print(f"sweep search bulk[{case}] slots={slots} "
                  f"ctas_per_sm={per_sm} ms={timer(bulk):.4f}", flush=True)


def sweep_deref(dev, timer) -> None:
    from repro_torch.kernels.compiled import kernel as rk
    gen = torch.Generator(device=dev).manual_seed(73)
    m, na = 1 << 22, 1 << 27
    port = torch.randn((1 << 24, 32), generator=gen, device=dev)
    a = torch.randint(0, port.shape[0], (na, 1), generator=gen, device=dev,
                      dtype=torch.int32)
    addrs = torch.randint(0, na, (m,), generator=gen, device=dev,
                          dtype=torch.int32)
    want = rk.ring_deref_plain(a, port, addrs)
    case = "2^22 via (2^27, 1) into (2^24, 32) f32, chunk 64"
    print(f"sweep deref[{case}] index hop alone (index_select of 2^22 words)"
          f" ms={timer(lambda: torch.index_select(a, 0, addrs)):.4f}",
          flush=True)
    rows = want[0].view(-1)
    print(f"sweep deref[{case}] ring_gather of the same rows ms="
          f"{timer(lambda: rk.ring_gather(port, rows, chunk=64, rif=16)):.4f}",
          flush=True)

    def run(**kw):
        got = rk.deref_rows(a, port, addrs, chunk=64, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ms = timer(lambda: rk.deref_rows(a, port, addrs, chunk=64, **kw))
        knobs = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"sweep deref[{case}] {knobs} ms={ms:.4f}", flush=True)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for rif_a in (1, 2, 4):
        run(rif_a=rif_a, rif_b=16)
    for per_sm in (8, 16, 32, 64):
        run(rif_a=1, rif_b=16, _ctas=per_sm * sms)


if __name__ == "__main__":
    sys.exit(main())
