#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. print the card's name and power limit, and the torch and CUDA
   versions;
2. build every CUDA kernel of ``src/repro_torch/csrc`` with ``nvcc``
   (one process per source, all started together);
3. hold each kernel against its plain PyTorch version at the main paths'
   shapes, and time kernel, plain version and a library yardstick with
   CUDA events (each launch timed with a cold L2): the embedding gather
   at every main-path shape (qwen3-4b's 10 KB rows at M 8 and 256,
   granite's 6 KB rows, minicpm3-4b's 10 KB rows and
   deepseek-v2-lite-16b's 8 KB rows, granite-34b's 24 KB rows,
   rwkv6-1.6b's 8 KB rows and hymba-1.5b's 6.4 KB rows at M 8, 256 and
   4096; the JSON row is qwen3's
   M 256 and carries the rest under ``cases``), each beside two
   calibrations under the same timer, an empty kernel and a
   device-to-device copy of the same bytes; the
   decode kernels at qwen3-4b's and granite-moe-3b-a800m's head shapes,
   and the paged one for a single request decoding (B 1); the contiguous
   decode at MLA's (G 1, D = dn + dr: minicpm3-4b's 40 heads of 96,
   deepseek-v2-lite-16b's 16 of 192), and at the two MLA models' serve
   shapes (S 1024, V zero-padded from 64 to 96 and from 128 to 192, as
   ``mla_apply`` gives it); both decodes at G 48 (granite-34b's 48 query
   heads over one KV head, D 128, S 1024: sub-groups of 8 rows); the
   contiguous decode at hymba-1.5b's serve shape (G 5 over 5 KV heads,
   D 64, S 1024);
   ``gmm`` at granite's and deepseek's (64 experts, top-6, F 1408)
   decode, prefill-chunk and ``lm_apply`` shapes (padding rows exactly
   zero; the JSON row carries the other five under ``cases``); ``flash`` at
   granite's and qwen3-4b's widths, windowed and at a length that is not
   a multiple of the block, at the two MLA models' forward widths, at
   granite-34b's (48 query heads over one KV head, D 128) and at
   hymba-1.5b's (25 heads over 5 KV heads, D 64, S 2048) with its
   1024-token window and without (its global layers), and without a
   causal mask at seamless-m4t-large-v2's shapes (the encoder: B 2, 16
   heads of 64, S 2048; the cross attention: B 8, ``Sq`` 1 and 32
   against ``Sk`` 1000 and 1024, and ``Sq`` 2048 against 1000), SDPA
   without a mask beside it; the decodes at chameleon-34b's and
   qwen2-72b's G 8, D 128, S 1024 and seamless's decoder (G 1 over 16
   KV heads, D 64); the gather also at seamless's 4 KB and qwen2-72b's
   32 KB rows; the shapes a rank of four computes in the sharded steps
   (model 4): ``flash`` at qwen2-72b's 16 heads over 2 KV heads, the
   contiguous decode at G 8 over 2 of 8 KV heads read in place from the
   whole cache and at granite-34b's G 12 over its one KV head, ``gmm``
   on 10 of granite's 40 experts; the JSON rows of the decodes and
   ``flash`` carry their other shapes under ``cases``;
4. check smoke-sized float32 models (qwen3-4b, granite, minicpm3-4b,
   deepseek-v2-lite-16b, granite-34b, rwkv6-1.6b, hymba-1.5b,
   chameleon-34b, qwen2-72b with nonzero QKV biases and
   seamless-m4t-large-v2 with frames; the recurrent pair and seamless
   through ``PagedServeLoop``'s contiguous fallback) serve the same
   tokens through the kernels as through the plain path, and that at
   one slot the coupled ``LegacyServeLoop`` (which has no encoder, as
   in the reference) serves the decoupled loop's tokens;
   build granite-moe-3b-a800m at full width (32 layers, bf16) from a
   seeded ``torch.Generator`` and check its first paged prefill-chunk and
   decode logits and its ``make_prefill_step`` logits through the
   kernels against the plain path, with the plain path given the
   kernel path's expert routing (a top-k choice flips on a rounding
   difference; the flips are counted and printed);
5. the main paths, each run with every launch count set to 0 just
   before it and read just after: granite's ``PagedServeLoop`` on 8
   requests (prompts of 1-700 tokens, 32 new each; 8 slots, s_max 1024,
   page 16, chunk 32) and its ``make_prefill_step`` on 2 x 2048 tokens;
   then qwen3-4b at full width (36 layers), its logits checked as
   granite's, served through ``PagedServeLoop`` (the same requests, then
   one prompt again for prefix reuse) and the contiguous ``ServeLoop``;
   then minicpm3-4b (MLA) at full width (62 layers, bf16), its paged and
   contiguous prefill-chunk and decode logits and its
   ``make_prefill_step`` logits checked as qwen3's, served the same way
   (the repeated prompt reusing latent pages), three decode steps of a
   further request traced with ``torch.profiler`` (device busy time,
   idle share and device time by kernel), and its ``make_prefill_step``
   on 2 x 2048 tokens; then deepseek-v2-lite-16b (MLA without a query
   rank, one dense layer, 26 MoE layers of 64 experts top-6 and 2 shared
   experts) at full depth (27 layers, bf16, ~15.7 B parameters), its
   logits checked as minicpm3's (the plain path replaying the kernel
   routing), served the same way and its ``make_prefill_step`` run.
   Every kernel of a path must have launched in it; on the MLA models'
   serve paths ``flash_decode`` launches once a layer a decode step and
   ``flash_decode_paged`` never (MLA decodes the gathered latent through
   the contiguous kernel, as the reference does), the gather once a
   step, and deepseek's ``gmm`` three times a MoE layer a step (78); the
   prefill steps launch ``flash`` once a layer (and deepseek's ``gmm``
   78 times); deepseek's two loops must serve equal streams;
6. the paper's irregular suite through ``repro_torch.core.decouple``, each
   path run with the counts set to 0 just before it and read just after:
   ``decoupled_searchsorted`` of 2^22 keys in a sorted 2^27-entry int32
   table, ``decoupled_hash_lookup`` of 2^20 keys over 2^24 entries in
   chains of 16 placed by a seeded permutation, ``decoupled_spmv`` of a
   65,536 x 2^24 CSR matrix with 8 entries a row (through ``csr_to_bsr``
   at 8 x 128), and ``decoupled_merge_sort`` of 2^24 int32 (tile 256)
   with one ``decoupled_merge`` of two sorted 2^23 runs (the sort's 16
   ``merge_tiles`` launches each timed between its own CUDA events,
   beside the sort's host wall, and a device-to-device copy of the 2^24
   keys as calibration; ``decoupled_searchsorted`` beside its parts, the
   summary gather, the summary search and the kernel).  Each result is
   checked against a library call (exact; SpMV in float32 within 1e-5 of
   the largest row sum of |val * vec|), each kernel against its plain
   version at the path's shapes, and timed beside its bound, its plain
   version and the library call;
7. the DAE compiler and the explicit-ring kernels, each path run with
   the counts set to 0 just before it and read just after:
   ``decoupled_gather(method="rif")`` of 256 and 2^16 rows of qwen3-4b's
   (151936, 2560) float32 embedding; ``compile_target`` then
   ``CompiledKernel()`` on the card for every target of
   ``COMPILE_TARGETS`` at "small" and for gather, binsearch and
   binsearch_for at "paper" (``benchmarks/compile_bench.py``'s sizes),
   each output bit-identical to the simulator oracle, with each pass's
   host seconds; ``chase=None`` on binsearch must raise ``CompileError``
   with the ChaseSpec hint.  Then ``ring_gather`` (2^22 addresses into a
   (2^24, 32) float32 port), ``ring_deref`` (2^22 addresses into a
   (2^27, 1) int32 index port over the same data port) and
   ``ring_chase`` (the binsearch_for spec over phase 6's table and keys,
   and the early-exit binsearch spec on the same keys, at the depth the
   compiled binsearch_for was planned with) at card-filling
   sizes, each exact against its plain version and timed beside its
   bound, its plain version and a library call (``ring_deref`` also
   beside its index hop alone, an ``index_select`` of the 2^22 words).  Each chase program's
   kernel is generated and built at its first use; the build seconds are
   printed.

8. the tuner (``repro_torch.tune``), into the fresh cache file under
   ``build/tune/`` that the script points ``$REPRO_TUNE_CACHE`` at
   before phase 2 (so phases 3-7 run the analytic knobs, whatever a
   developer's cache holds): ``tune_kernel`` (at most 16 points, best of
   2 CUDA-event timings each) for every op of ``KERNEL_DIMS`` at the
   shapes of ``TUNE_SHAPES`` (the gather at qwen3-4b's table for a
   prefill chunk and for ``rif_gather``'s 2^16 rows, the decodes at
   qwen3's serve shapes, ``gmm`` at deepseek's decode step, the irregular
   ops at phase 6's sizes; SpMV at 2^16 entries, whose largest block
   shape holds 2 GiB), ``tune_compiled`` for every target at "small" and
   binsearch at "paper", and ``tune_workload`` for four workloads at
   "small".  Each prints the seed and its time, the winner and its time,
   the evals, a second call's 0 evals (a cache hit) and one dispatch with
   every knob ``None``: the kernel wrapper, spied at the dispatcher's
   seam, must receive the winner's knobs and launch, and the output
   equal the plain version's (compiled targets: every plan from the
   cache, bit-identical to the simulator oracle; workloads: the winner's
   cycles again through ``run_workload``).  Last, the host cost of one
   dispatcher lookup, on a miss and on a hit.

9. (run after phase 7 and before phase 8, while the tune cache is still
   empty: phase 8's decode winners are timed at G 4) the port's
   ``serve`` axis through ``repro_torch.bench``: granite-34b at full
   width (88 layers, bf16, ~34 B parameters, ~63.3 GiB), its paged and
   contiguous prefill-chunk and decode logits and its
   ``make_prefill_step`` logits checked as qwen3's, its
   ``make_prefill_step`` on 2 x 2048 tokens (``flash`` 88 launches),
   then four cells run by ``run_axis`` into
   ``build/bench/BENCH_serve.json``: ``PagedServeLoop`` and
   ``ServeLoop`` on the 8 requests of phase 5 (the paged cell also
   serves the 700-token prompt again; ``flash_decode_paged`` or
   ``flash_decode`` 88 a decode step, 8/8 streams equal across the
   two), the coupled ``LegacyServeLoop`` against ``ServeLoop`` (chunk
   16, s_max 128) on the serve bench's "mixed" mix (requests of 4 and 48
   prompt tokens alternating, 16 new each; 4 requests, cut from 8 for
   time; tokens/s of both and their ratio), and both loops at one slot
   (one 48-token prompt, 8 new; the first token's logits of the two held
   to the bf16 logit limit); each cell's warm time is its serve wall.
   The axis runs twice; each report is validated by the port's schema
   and the two are diffed by ``diff_reports``: any finding but a
   wall-clock one fails.

10. (run after phase 9 and before phase 8) training, through
   ``make_train_step`` with ``kernel_mode="ref"`` (JAX trains on its
   plain path only: no Pallas kernel has a backward, so this phase
   launches no hand-written kernel and requires that none launched):
   granite-moe-3b-a800m at full width and depth (32 layers, 3.30 B
   parameters, float32 parameters and AdamW state, ~49 GiB, bf16
   compute) for 8 AdamW steps (lr 3e-4) on one repeated ``SyntheticLM``
   batch of 4 x 1024 tokens: every loss and grad norm finite and the
   last loss below the first; each step's wall after a synchronise,
   forward+backward and optimizer device time by CUDA events, tokens/s,
   peak memory and model FLOP/s (6 x active matrix parameters x tokens
   over the step) against 989 TFLOP/s.  Then one train step at full
   width and depth 2 in float32 (B 1 x 128) on the card and on the CPU
   from the same numpy weights: loss within 1e-5 relative, grad norm
   within 1e-4 relative and every gradient leaf within 1e-4 of its
   largest |g|; the same step in ``kernel`` mode must raise
   ``NotImplementedError`` on CUDA tensors.  Last ``fit`` at depth 2:
   6 steps, a checkpoint every 2 (async, under ``build/train_ckpt/``), a
   ``StepFailure`` injected at step 3 (one restart, from step 2), then a
   second call to 8 that resumes at 6 and runs 2 steps; every published
   file and every restore is held bit for bit to an independent copy of
   the state taken when its save was asked for, and each write's seconds
   and bytes are printed.

11. (run after phase 10 and before phase 8, so its decodes dispatch the
   analytic knobs) the recurrent families at full width and depth, bf16,
   from a seeded ``torch.Generator``: rwkv6-1.6b (24 ``rwkv`` layers,
   ~1.58 B parameters) and hymba-1.5b (32 layers, ~1.66 B parameters:
   attention and an SSM in parallel, a 1024-token window on 29 layers).
   For each: the first contiguous prefill-chunk and decode logits and the
   ``make_prefill_step`` logits on 2 x 2048 tokens through the kernels
   against the plain path (RWKV bit-equal, its only kernel being the
   exact gather; Hymba's serve logits within the bf16 logit limit, its
   prefill step's 32 ``flash`` calls each within the bf16 limit of the
   plain attention on the model's own activations and its logits within
   the larger of the logit limit and SDPA's own error against the plain
   path: through 32 layers any bf16 attention's rounding grows past the
   logit limit there, SDPA's more than the kernel's; and against a
   float32 plain forward at the same weights, no farther from it than
   SDPA's); phase 5's 8 requests
   through ``PagedServeLoop``, which must fall back to the contiguous path
   (``paged`` False, 0 page allocations), and through ``ServeLoop``, 8/8
   streams equal, with walls, tokens/s, TTFT and peak memory; the
   launches of each path (Hymba: ``flash_decode`` 32 a decode step,
   ``flash`` 32 a prefill step; neither model ``flash_decode_paged`` nor
   ``gmm``); one decode step with all 8 slots live traced with
   ``torch.profiler`` (device busy time, idle share, operations a step);
   the prefill step's wall.

12. (run after phase 11 and before phase 8, so its dispatches take the
   analytic knobs) the last three configurations at published widths,
   bf16, seeded, each freed before the next is built: chameleon-34b
   (``vlm``, qk-norm; 48 layers, 34.29 B parameters) at CHAMELEON_DEPTH
   layers and qwen2-72b (QKV biases drawn N(0, 0.5); 80 layers do not
   fit one card) at QWEN2_DEPTH layers, both cut to make room for phases
   13-15: the first paged prefill-chunk and decode logits
   and ``make_prefill_step``'s on 2 x 2048 tokens through the kernels
   against the plain path within the logit limit, the prefill step's
   wall (``flash`` once a layer), phase 5's 8 requests through
   ``PagedServeLoop`` (``flash_decode_paged`` once a layer a decode
   step, no ``gmm``) with wall, tokens/s, TTFT, page allocations and
   peak memory; then seamless-m4t-large-v2 (24 ``enc`` + 24 ``xattn``
   layers) with seeded frames of S_ENC positions a request: its
   ``make_prefill_step`` (the encoder, ``flash`` with ``causal=False``)
   on 2 x 2048 frames and the first prefill-chunk and decode logits
   against the plain path, phase 5's requests through ``PagedServeLoop``
   (which must fall back: ``paged`` False, 0 page allocations) and
   ``ServeLoop``, 8/8 streams equal, each loop's ``flash`` launches 24
   an encoding plus 24 x (CHUNK a prefill chunk, one query at a time,
   and 1 a decode step) and ``flash_decode`` 24 a decode step; last one
   decode step of 8 slots timed beside the 24 ``cross_kv`` projections
   it recomputes.
13. (run right after phase 5's qwen3-4b, on its build, before the tuner)
   disaggregated serving through ``ShardedPagedServeLoop``: (a)
   co-located on ``make_serve_meshes(1)``, phase 5's requests and the
   700-token prompt again, every stream, the ten counters and the
   ``flash_decode_paged`` and ``dae_gather`` launch counts equal to
   phase 5's ``PagedServeLoop``'s, its ``handoff`` a span-1
   ``MeshChannel``; (b) the Access and Execute engines on the two
   slots of ``make_serve_meshes(2, devices=[cuda, cuda])``, 8/8 streams
   equal to a ``PagedServeLoop(prefix_reuse=False)``'s, 8 migrations
   from a 513-page staging pool, each migration's pages, bytes and wall
   (gather + host hop + scatter), their total and share of the loop's
   wall, and both loops' TTFT.
14. (run right after phase 13, on phase 5's qwen3-4b build) the
   collectives in a one-rank ``nccl`` group made in this process (a
   ``HashStore``, this card the group's device; destroyed at the end):
   (a) ``ShardedPagedServeLoop`` on ``make_serve_meshes(ranks=True)``,
   phase 5's requests and the prompt again, its streams, ten counters
   and ``flash_decode_paged``/``dae_gather`` launches equal to phase
   5's, its one-way sharded pool gathered whole in every layer (the
   pool bytes a step gathers and one step's gathers and keep-backs in
   device ms printed); (b) ``make_ep_moe`` on a (1, 1) mesh with
   granite-moe-3b-a800m's layer-0 experts (40, top-8, D 1536, F 512),
   256 tokens, dropless, within the bf16 limit of ``ep_moe_reference``;
   (c) ``compressed_grad_mean`` over one qwen3-4b layer's weights in
   float32: mean + residual within 1e-6 of them; (d)
   ``pipeline_forward`` with one stage at qwen3's width against the
   stage applied directly.

15. the sharded steps of ``launch/steps.py`` on a (1, 1) rank mesh in a
   one-rank ``nccl`` group: (a) right after phase 14, on phase 5's
   qwen3-4b build, ``shard_prefill_step`` on 2 x 2048 and 16 greedy
   ``shard_serve_step``s of 8 rows at s_max 1024, logits and caches
   bit-equal to ``make_prefill_step``/``make_serve_step``, ``flash`` 36
   and ``dae_gather`` 1 a prefill step, ``flash_decode`` 36 and
   ``dae_gather`` 1 a serve step, both sides' walls; (b) after phase 10
   has freed its trainer, from phase 10's seeded start (granite-moe at
   full depth), two steps of ``make_train_step`` and then two of
   ``shard_train_step`` on a (1, 1) mesh, both under
   ``torch.use_deterministic_algorithms`` (the ref MoE's float32
   ``index_add_`` adds in a run-dependent order on the card otherwise,
   so the unsharded step does not repeat its own bits: its distance
   from phase 10's first two steps is printed): loss and grad norm bit
   for bit equal, and no kernel launched.

It prints a ``{"kernels": [...]}`` line and, last, the contract line
``{"ok": true, "device": {...}}``.  Without a card, or without the
repository's ``src/`` beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # H100 SXM data sheet, dense tensor cores
BF16_RTOL = 2.0 ** -7          # one bf16 ulp, relative
BF16_ATOL = 1e-3
# Logits are bf16 products: a rounding flip upstream moves a logit by
# an ulp of its own size.  Allow 4 bf16 ulps at the largest logit.
LOGIT_RTOL = 2.0 ** -5

SLOTS, S_MAX, PAGE, CHUNK, MAX_NEW = 8, 1024, 16, 32, 32
BT = 128                       # tokens per grouped-matmul block (moe.py)
PREFILL_B, PREFILL_S = 2, 2048          # the make_prefill_step run
CHECK_B, CHECK_S = 2, 512               # its kernel-vs-plain check
GRANITE, QWEN, MINICPM = "granite-moe-3b-a800m", "qwen3-4b", "minicpm3-4b"
DEEPSEEK, GRANITE34 = "deepseek-v2-lite-16b", "granite-34b"
RWKV6, HYMBA = "rwkv6-1.6b", "hymba-1.5b"
CHAMELEON, QWEN2 = "chameleon-34b", "qwen2-72b"
SEAMLESS = "seamless-m4t-large-v2"
# phase 12's depths, cut to make room for phases 13-15 in the time
# limit: qwen2-72b's 80 layers (~137.8 GiB in bf16) never fit one card
# (tools/shard_dist.py runs them on four), 36 of them ran until phase
# 13 came and 12 until phase 15; chameleon-34b ran its full 48, then 16
QWEN2_DEPTH = 8
CHAMELEON_DEPTH = 8
S_ENC = 1024                   # seamless's encoder positions a request
# phase 9's comparator cells (benchmarks/serve_bench.py's "mixed" mix)
MIXED, LEGACY_NEW, LEGACY_S_MAX, LEGACY_CHUNK = (4, 48), 16, 128, 16
LEGACY_REQUESTS = 4      # cut from 8 to keep phase 9 near 3 minutes
PARITY_PROMPT, PARITY_NEW = 48, 8
# the serve loops' counters phase 13 holds equal to phase 5's
SERVE_COUNTERS = ("prefill_steps", "decode_steps", "prefill_tokens",
                  "decode_tokens", "admitted", "page_allocs", "cow_copies",
                  "preemptions", "prefix_hits", "migrations")
# phase 9's reports, beside the kernel builds and the tune cache
OUT_DIR = Path(__file__).resolve().parent / "build" / "bench"
# the MoE expert shapes phase 3 times gmm at: (experts, top-k, D, F)
GRANITE_MOE = (40, 8, 1536, 512)
DEEPSEEK_MOE = (64, 6, 2048, 1408)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def assert_close_bf16(name, got, want) -> float:
    err = (got.float() - want.float()).abs()
    limit = BF16_ATOL + BF16_RTOL * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    if bool((err > limit).any()):
        raise AssertionError(f"{name}: max |err| {float(err.max())} exceeds "
                             f"{BF16_ATOL} + {BF16_RTOL} * |plain|")
    return float(err.max())


def row_line(r, card) -> str:
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    limit = r.get("limit", f"{BF16_ATOL} + {BF16_RTOL} * |plain|")
    return (f"kernel {r['name']}{r.get('case', '')}: max_abs_err "
            f"{r['max_abs_err']} (limit {limit}) "
            f"ms {r['ms']:.4f} plain {r['plain_ms']:.4f} library {lib}"
            f"{r.get('library', '')} bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}) ({card})")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


# the embedding gathers of the main paths: (model, table rows, width)
# by M, the rows of a decode step (8 slots x 1), a prefill chunk (8 x 32)
# and a make_prefill_step (2 x 2048)
GATHER_SHAPES = (("qwen3-4b", 151_936, 2560, (SLOTS, SLOTS * CHUNK)),
                 ("granite", 49_155, 1536,
                  (SLOTS, SLOTS * CHUNK, PREFILL_B * PREFILL_S)),
                 ("minicpm3-4b", 73_448, 2560,
                  (SLOTS, SLOTS * CHUNK, PREFILL_B * PREFILL_S)),
                 ("deepseek-v2-lite-16b", 102_400, 2048,
                  (SLOTS, SLOTS * CHUNK, PREFILL_B * PREFILL_S)),
                 ("granite-34b", 49_152, 6144,
                  (SLOTS, SLOTS * CHUNK, PREFILL_B * PREFILL_S)),
                 ("rwkv6-1.6b", 65_536, 2048,
                  (SLOTS, SLOTS * CHUNK, PREFILL_B * PREFILL_S)),
                 ("hymba-1.5b", 32_001, 1600,
                  (SLOTS, SLOTS * CHUNK, PREFILL_B * PREFILL_S)),
                 ("seamless-m4t-large-v2", 256_206, 1024,
                  (SLOTS, SLOTS * CHUNK, PREFILL_B * PREFILL_S)),
                 ("qwen2-72b", 152_064, 8192,
                  (SLOTS, SLOTS * CHUNK, PREFILL_B * PREFILL_S)))


def check_gather(dev, timer, card):
    """gather_rows at every main-path shape against its plain version,
    timed beside its bound, the plain version, index_select and two
    calibrations under the same timer: an empty kernel
    (torch.cuda._sleep(0)) and a device-to-device copy of the same bytes
    (cudaMemcpyAsync through copy_).  The row is qwen3's prefill chunk;
    the other shapes ride under "cases"."""
    from repro_torch.kernels.dae_gather import kernel as gk
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for model, n, d, ms in GATHER_SHAPES:
        table = torch.randn((n, d), generator=gen, device=dev)
        for m in ms:
            idx = torch.randint(0, n, (m,), generator=gen, device=dev,
                                dtype=torch.int32)
            idx[:4] = torch.tensor([0, n - 1, 7, 7], dtype=torch.int32)
            idx[-2:] = idx[4:6]                           # repeats
            got = gk.gather_rows(table, idx)
            want = gk.gather_rows_plain(table, idx)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"dae_gather [{model} M {m}]: kernel "
                                     "differs from plain")
            src, dst = table[:m].clone(), torch.empty_like(want)
            b_ms, b_by = bound(2 * m * d * 4 + m * 4, 0)
            r = {"name": "dae_gather", "route": "cuda",
                 "source": "src/repro_torch/csrc/dae_gather.cu",
                 "replaces": "src/repro/kernels/dae_gather/kernel.py:49",
                 "max_abs_err": 0.0, "limit": "0, exact",
                 "case": f" [{model} ({n}, {d}) f32, M {m}]",
                 "ms": timer(lambda: gk.gather_rows(table, idx)),
                 "plain_ms": timer(lambda: gk.gather_rows_plain(table,
                                                                idx)),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": timer(lambda: torch.index_select(table, 0,
                                                                idx)),
                 "library": " (index_select)"}
            empty_ms = timer(lambda: torch.cuda._sleep(0))
            copy_ms = timer(lambda: dst.copy_(src))
            log(f"dae_gather{r['case']}: empty kernel {empty_ms:.4f} ms, "
                f"device-to-device copy of the same {m * d * 4} bytes "
                f"{copy_ms:.4f} ms ({card})")
            rows.append(r)
        del table
    main = next(r for r in rows if "qwen3-4b" in r["case"]
                and r["case"].endswith(f"M {SLOTS * CHUNK}]"))
    return main, rows


def _decode_cost(lengths, kvh, g, d, esize, extra_bytes):
    tokens = float(lengths.sum())
    nbytes = tokens * kvh * d * esize * 2 + extra_bytes
    return bound(nbytes, tokens * kvh * g * d * 4)


def _sdpa_decode(q, kc, vc, lengths):
    b, kvh, g, d = q.shape
    mask = (torch.arange(kc.shape[2], device=q.device)[None, :]
            < lengths[:, None].long())[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q.reshape(b, kvh * g, 1, d), kc, vc, attn_mask=mask,
        scale=d ** -0.5, enable_gqa=True)


def check_decode(dev, timer, g: int, d: int, case: str, kvh: int = 8,
                 paged: bool = True, s: int = 2048, dv: int = 0,
                 of_heads: int = 0):
    """Contiguous and (``paged``) paged decode with B 8, ``kvh`` KV heads,
    G query rows per KV head and head dim D, bf16, lengths 1, 16, 17, S
    and four seeded in 1..S, pages of 16 under a shuffled page table.
    ``dv`` > 0 zeroes V past its first ``dv`` columns, as MLA pads V.
    ``of_heads`` > 0: the contiguous caches are a tensor-parallel rank's
    ``kvh`` heads of caches with ``of_heads`` (the view
    ``cache[:, kvh:2 kvh]``, read in place)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(2)
    b = SLOTS
    npb = s // PAGE
    scale = d ** -0.5
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[:4] = torch.tensor([1, PAGE, PAGE + 1, s], dtype=torch.int32)
    q = torch.randn((b, kvh, g, d), generator=gen, device=dev
                    ).to(torch.bfloat16)
    rows = []

    kc = torch.randn((b, of_heads or kvh, s, d), generator=gen, device=dev
                     ).to(torch.bfloat16)
    vc = torch.randn((b, of_heads or kvh, s, d), generator=gen, device=dev
                     ).to(torch.bfloat16)
    if dv:
        vc[..., dv:] = 0
    if of_heads:
        kc, vc = kc[:, kvh:2 * kvh], vc[:, kvh:2 * kvh]
    got = fk.flash_decode(q, kc, vc, lengths, scale=scale)
    want = fk.decode_plain(q, kc, vc, lengths, scale=scale)
    torch.cuda.synchronize()
    err = assert_close_bf16(f"flash_decode {case}", got, want)
    b_ms, b_by = _decode_cost(lengths, kvh, g, d, 2, 2 * q.numel() * 2 + 4 * b)
    rows.append({"name": "flash_decode", "case": case, "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_decode.cu",
                 "replaces":
                     "src/repro/kernels/flash_attention/kernel.py:175",
                 "max_abs_err": err,
                 "ms": timer(lambda: fk.flash_decode(q, kc, vc, lengths,
                                                     scale=scale)),
                 "plain_ms": timer(lambda: fk.decode_plain(
                     q, kc, vc, lengths, scale=scale)),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": timer(lambda: _sdpa_decode(q, kc, vc,
                                                          lengths))})
    del kc, vc
    if not paged:
        return rows

    n_pages = 1 + b * npb
    kp = torch.randn((n_pages, kvh, PAGE, d), generator=gen, device=dev
                     ).to(torch.bfloat16)
    vp = torch.randn((n_pages, kvh, PAGE, d), generator=gen, device=dev
                     ).to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    table = perm.to(torch.int32).reshape(b, npb).contiguous()
    rows.append(_paged_row(fk, q, kp, vp, table, lengths, scale, timer,
                           case))
    return rows


def _paged_row(fk, q, kp, vp, table, lengths, scale, timer, case):
    b, kvh, g, d = q.shape
    got = fk.flash_decode_paged(q, kp, vp, table, lengths, scale=scale)
    want = fk.decode_paged_plain(q, kp, vp, table, lengths, scale=scale)
    torch.cuda.synchronize()
    err = assert_close_bf16(f"flash_decode_paged {case}", got, want)
    blocks = float(((lengths + PAGE - 1) // PAGE).sum())
    b_ms, b_by = _decode_cost(lengths, kvh, g, d, 2,
                              2 * q.numel() * 2 + 4 * b + 4 * blocks)
    kcg, vcg = fk.pages_to_cache(kp, table), fk.pages_to_cache(vp, table)
    pps, nsplit = fk.paged_splits(b, kvh, table.shape[1],
                                  torch.cuda.get_device_properties(
                                      q.device).multi_processor_count)
    return {"name": "flash_decode_paged", "route": "cuda",
            "case": f"{case} [{nsplit} splits of {pps} pages]",
            "source": "src/repro_torch/csrc/flash_decode_paged.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:233",
            "max_abs_err": err,
            "ms": timer(lambda: fk.flash_decode_paged(
                q, kp, vp, table, lengths, scale=scale)),
            "plain_ms": timer(lambda: fk.decode_paged_plain(
                q, kp, vp, table, lengths, scale=scale)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer(lambda: _sdpa_decode(q, kcg, vcg, lengths))}


def check_decode_single(dev, timer):
    """The paged decode of one request (B 1) at qwen3-4b's head shape:
    a 2048-token sequence in a shuffled pool, its 8 heads split across
    the card."""
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(3)
    kvh, g, d, s = 8, 4, 128, 2048
    npb = s // PAGE
    q = torch.randn((1, kvh, g, d), generator=gen, device=dev
                    ).to(torch.bfloat16)
    kp = torch.randn((1 + npb, kvh, PAGE, d), generator=gen, device=dev
                     ).to(torch.bfloat16)
    vp = torch.randn_like(kp)
    table = (torch.randperm(npb, generator=gen, device=dev) + 1).to(
        torch.int32).reshape(1, npb)
    lengths = torch.tensor([s], dtype=torch.int32, device=dev)
    return _paged_row(fk, q, kp, vp, table, lengths, d ** -0.5, timer,
                      "[qwen3-4b G4 D128, B 1]")


def _grouped_mm_yardstick(xs, w, counts):
    """One library call for the same grouped product: ``torch._grouped_mm``
    over the padded expert groups where this PyTorch has it, else a
    ``torch.matmul`` per non-empty group.  Returns (fn, its name)."""
    padded = (counts + BT - 1) // BT * BT
    offs = torch.cumsum(padded, 0).to(torch.int32)
    grouped = getattr(torch, "_grouped_mm", None)
    if grouped is not None:
        for wl, name in ((w, "torch._grouped_mm"),
                         (w.transpose(1, 2).contiguous().transpose(1, 2),
                          "torch._grouped_mm (column-major w)")):
            try:
                grouped(xs, wl, offs=offs)
                torch.cuda.synchronize()
                return (lambda: grouped(xs, wl, offs=offs)), name
            except (RuntimeError, TypeError, ValueError):
                pass
    groups = [(e, int(s), int(n)) for e, (s, n) in enumerate(zip(
        (offs - padded.to(torch.int32)).tolist(), padded.tolist())) if n]

    def loop():
        return [xs[s:s + n] @ w[e] for e, s, n in groups]
    return loop, "torch.matmul per expert"


def check_gmm(dev, timer, tokens: int, case: str, shape=GRANITE_MOE,
              local: int = 0):
    """An expert product (``shape``: experts, top-k, D, F; granite's by
    default) on the blocks the MoE dispatch builds for ``tokens`` tokens
    routed at random; ``local`` > 0: on the blocks of a tensor-parallel
    rank's ``local`` experts (the pairs routed to the others are not
    its)."""
    from repro_torch.kernels.grouped_matmul import kernel as mk
    from repro_torch.models import moe
    gen = torch.Generator(device=dev).manual_seed(tokens)
    e, k, d, f = shape
    experts = torch.rand((tokens, e), generator=gen, device=dev).topk(
        k, dim=-1).indices.to(torch.int32)
    if local:
        e = local
        _, se, stok, counts, pos, _ = moe._local_pairs(experts, 0, e)
        counts, mine = counts[:e], se < e
        se, stok, pos = se[mine], stok[mine], pos[mine]
    else:
        _, se, stok, counts, pos = moe.sort_pairs(experts, e)
    tp, starts, be, rows = moe.block_layout(counts, tokens * k, BT)
    x = torch.randn((tokens, d), generator=gen, device=dev
                    ).to(torch.bfloat16)
    xs = x.new_zeros((tp, d))
    xs[starts[se] + pos] = x[stok]
    w = (torch.randn((e, d, f), generator=gen, device=dev)
         * d ** -0.5).to(torch.bfloat16)
    got = mk.gmm(xs, w, be, bt=BT, block_rows=rows)
    want = mk.gmm_plain(xs, w, be, bt=BT, block_rows=rows)
    torch.cuda.synchronize()
    err = assert_close_bf16(f"gmm {case}", got, want)
    r = torch.arange(tp, device=dev)
    if not bool((got[r % BT >= rows[r // BT]] == 0).all()):
        raise AssertionError(f"gmm {case}: a padding row is not zero")
    real, hit = int(rows.sum()), int((counts > 0).sum())
    b_ms, b_by = bound(real * d * 2 + hit * d * f * 2 + tp * f * 2
                       + 8 * be.numel(), 2.0 * real * d * f)
    lib_fn, lib_name = _grouped_mm_yardstick(xs, w, counts)
    log(f"gmm {case}: {tokens} tokens x top-{k} = {real} rows in "
        f"{tp // BT} blocks of {BT} ({hit} experts hit, "
        f"{int((rows == 0).sum())} blocks without a real row)")
    return {"name": "gmm", "case": case, "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/grouped_matmul/kernel.py:68",
            "max_abs_err": err,
            "ms": timer(lambda: mk.gmm(xs, w, be, bt=BT, block_rows=rows)),
            "plain_ms": timer(lambda: mk.gmm_plain(xs, w, be, bt=BT,
                                                   block_rows=rows)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer(lib_fn), "library": f" ({lib_name})"}


def _visible_pairs(s: int, window) -> int:
    rows = np.arange(s)
    return int(np.minimum(rows + 1, window or s).sum())       # causal


def check_flash(dev, timer, h, kvh, s, d, window, case: str,
                causal: bool = True, sq: int = 0, b: int = PREFILL_B):
    """Forward attention, bf16, B ``b``, ``s`` keys: causal (``sq`` = S
    queries) or, ``causal=False``, bidirectional with ``sq`` queries (the
    encoder's S, or the cross attention's 1 or a chunk against S_enc
    keys); SDPA without a mask is its library call."""
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(s + d + sq)
    sq = sq or s
    q = torch.randn((b, h, sq, d), generator=gen, device=dev
                    ).to(torch.bfloat16)
    k = torch.randn((b, kvh, s, d), generator=gen, device=dev
                    ).to(torch.bfloat16)
    v = torch.randn((b, kvh, s, d), generator=gen, device=dev
                    ).to(torch.bfloat16)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    got = fk.flash(q, k, v, **kw)
    want = fk.attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = assert_close_bf16(f"flash {case}", got, want)
    del want
    pairs = _visible_pairs(s, window) if causal else sq * s
    b_ms, b_by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                       4.0 * b * h * pairs * d)
    if not causal:
        def lib():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, enable_gqa=True)
    elif window is None:
        def lib():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
    else:
        rows = torch.arange(s, device=dev)[:, None]
        cols = torch.arange(s, device=dev)[None, :]
        mask = (cols <= rows) & (cols >= rows - window + 1)

        def lib():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)
    return {"name": "flash", "case": case, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_prefill.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:86",
            "max_abs_err": err,
            "ms": timer(lambda: fk.flash(q, k, v, **kw)),
            "plain_ms": timer(lambda: fk.attention_plain(q, k, v, **kw),
                              iters=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer(lib), "library": " (SDPA)"}


# ---------------------------------------------------------------------------
# phase 4: the models through the kernels against the plain path
# ---------------------------------------------------------------------------


class RoutingReplay:
    """Records the expert routing of every MoE layer on one run and hands
    the same routing to the next run, counting the tokens whose own
    top-k set differed there (``flips`` of ``tokens``).  Without it a
    near-tie in a router's top-k resolves one way through the kernels
    and the other way through the plain path, and the comparison would
    measure the flip, not the kernels."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe._route
        self.log, self.flips, self.tokens = [], 0, 0

    def record(self):
        def route(cfg, p, x2d):
            out = self.route(cfg, p, x2d)
            self.log.append(out)
            return out
        self.moe._route = route

    def replay(self):
        it = iter(self.log)

        def route(cfg, p, x2d):
            _, own = self.route(cfg, p, x2d)
            gates, experts = next(it)
            same = (own.sort(-1).values == experts.sort(-1).values).all(-1)
            self.flips += int((~same).sum())
            self.tokens += int(same.numel())
            return gates, experts
        self.moe._route = route

    def restore(self):
        self.moe._route = self.route


def first_logits(cfg, params, dev, paged: bool):
    """Prefill one chunk per slot, then one decode step; returns both
    logits.  Inputs, the decoded token included, are seeded, so two calls
    see the same data (an argmax of each call's own logits would differ
    where two logits nearly tie)."""
    from repro_torch.models import transformer as t
    rng = np.random.default_rng(3)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (SLOTS, CHUNK)),
                          dtype=torch.int32, device=dev)
    n_valid = torch.as_tensor(rng.integers(1, CHUNK + 1, SLOTS),
                              dtype=torch.int32, device=dev)
    n_valid[0] = CHUNK
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab, (SLOTS, 1)),
                          dtype=torch.int32, device=dev)
    pos = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
    npb = 4
    if paged:
        caches = t.lm_cache_init_paged(cfg, SLOTS, 1 + SLOTS * npb, PAGE, dev)
        table = (torch.arange(SLOTS * npb, dtype=torch.int32, device=dev)
                 + 1).reshape(SLOTS, npb)
        kw = {"page_table": table}
    else:
        caches = t.lm_cache_init(cfg, SLOTS, npb * PAGE, dev)
        kw = {}
    with torch.inference_mode():
        pre, caches = t.lm_prefill(cfg, params, caches, tok, pos, n_valid,
                                   **kw)
        dec, _ = t.lm_prefill(cfg, params, caches, nxt, n_valid,
                              torch.ones_like(n_valid), **kw)
    return {"prefill": pre, "decode": dec}


def prefill_step_logits(cfg, params, dev, b: int, s: int):
    from repro_torch.launch.steps import make_prefill_step
    tok = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (b, s)), dtype=torch.int32, device=dev)
    return make_prefill_step(cfg, dev)(params, {"tokens": tok})


def check_logits(cfg, params, dev, paged_kinds, with_step: bool,
                 step_shape=(CHECK_B, CHECK_S), exact: bool = False):
    """Logits through the kernels against the plain path (``ref`` mode,
    dropless capacity as in serving), the plain path replaying the
    kernel path's expert routing; ``make_prefill_step``'s at
    ``step_shape`` with ``with_step``.  ``exact``: the two must be
    bit-equal (a path whose only kernel is the exact gather)."""
    ref_cfg = dataclasses.replace(cfg, kernel_mode="ref",
                                  capacity_factor=float(cfg.n_experts or 1))

    def run(c):
        out = {}
        for paged in paged_kinds:
            kind = "paged" if paged else "contiguous"
            for name, v in first_logits(c, params, dev, paged).items():
                out[f"{kind}_{name}"] = v
        if with_step:
            out["prefill_step"] = prefill_step_logits(c, params, dev,
                                                      *step_shape)
        return out

    replay = RoutingReplay()
    try:
        replay.record()
        kern = run(cfg)
        replay.replay()
        ref = run(ref_cfg)
    finally:
        replay.restore()
    errs = {}
    for name, a in kern.items():
        b = ref[name]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name} logits not finite")
        err = float((a - b).abs().max())
        limit = 0.0 if exact else LOGIT_RTOL * float(b.abs().max())
        if err > limit or (exact and not torch.equal(a, b)):
            raise AssertionError(f"{name} logits: kernel vs plain max |err| "
                                 f"{err} > {limit}")
        errs[name] = (err, limit)
    if replay.tokens:
        errs["routing_flips_of_tokens"] = (replay.flips, replay.tokens)
    return errs


def check_small_serve(dev, arch):
    """Smoke-sized float32 model on the card: the kernels must serve the
    same tokens as the plain path, paged and contiguous; at one slot the
    coupled ``LegacyServeLoop`` must serve the decoupled loop's."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serve_loop import (LegacyServeLoop,
                                                PagedServeLoop, Request,
                                                ServeLoop)
    streams = {}
    for mode in ("kernel", "ref"):
        cfg = get_config(arch, smoke=True, kernel_mode=mode)
        bundle = build_model(cfg, dev)
        params = bundle.init(torch.Generator(device=dev).manual_seed(0))
        if cfg.qkv_bias:
            seed_biases(params, dev, 7)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, size=n)
                   for n in (12, 3, 25, 7, 1, 18)]
        # the encoder-decoder's requests carry frames of 24 positions
        frames = (seamless_frames(cfg.d_model, len(prompts), 1, 24)
                  if cfg.family == "encdec" else [None] * len(prompts))
        for cls in (PagedServeLoop, ServeLoop):
            kw = {"page": 8} if cls is PagedServeLoop else {}
            loop = cls(cfg, bundle, params, batch_slots=4, s_max=40,
                       chunk=16, **kw)
            streams[mode, cls.__name__] = loop.run(
                [Request(rid=i, prompt=p, max_new=8, frames=f)
                 for i, (p, f) in enumerate(zip(prompts, frames))])
        if cfg.family == "encdec":     # the coupled loop has no encoder,
            continue                   # as in the reference
        # one slot, one request from a fresh cache: the coupled loop is
        # correct there and must serve the decoupled loop's tokens
        prompt = rng.integers(0, cfg.vocab, size=PARITY_PROMPT)
        for cls, kw in ((ServeLoop, {"chunk": LEGACY_CHUNK}),
                        (LegacyServeLoop, {})):
            streams[mode, "one slot", cls.__name__] = cls(
                cfg, bundle, params, batch_slots=1, s_max=64, **kw).run(
                [Request(rid=0, prompt=prompt, max_new=PARITY_NEW)])
    ref = streams["ref", "PagedServeLoop"]
    one = streams.get(("ref", "one slot", "ServeLoop"), {0: []})
    for key, res in streams.items():
        if res != (one if "one slot" in key else ref):
            raise AssertionError(f"{arch} smoke serve {key} tokens differ "
                                 "from the plain path's")
    return sum(len(v) for v in ref.values()) + len(one[0])


# ---------------------------------------------------------------------------
# phase 5: the main paths
# ---------------------------------------------------------------------------


def main_requests(vocab: int):
    from repro_torch.runtime.serve_loop import Request
    rng = np.random.default_rng(0)
    lens = [1, 700] + list(rng.integers(2, 700, SLOTS - 2))
    prompts = [rng.integers(0, vocab, size=int(n)) for n in lens]
    return prompts, [Request(rid=i, prompt=p, max_new=MAX_NEW)
                     for i, p in enumerate(prompts)]


def serve(loop, requests):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = loop.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for req in requests:
        if len(res[req.rid]) != req.max_new:
            raise AssertionError(f"request {req.rid}: {len(res[req.rid])} "
                                 f"tokens, expected {req.max_new}")
    return res, wall


class Launches:
    """The kernels' launch counters, set to 0 before a path and read
    after it."""

    def __init__(self):
        from repro_torch.kernels.compiled import kernel as rk
        from repro_torch.kernels.dae_chase import kernel as ck
        from repro_torch.kernels.dae_gather import kernel as gk
        from repro_torch.kernels.dae_merge import kernel as mgk
        from repro_torch.kernels.dae_spmv import kernel as sk
        from repro_torch.kernels.flash_attention import kernel as fk
        from repro_torch.kernels.grouped_matmul import kernel as mk
        self.fns = {"dae_gather": gk.gather_rows, "gmm": mk.gmm,
                    "flash": fk.flash, "flash_decode": fk.flash_decode,
                    "flash_decode_paged": fk.flash_decode_paged,
                    "searchsorted_blocks": ck.searchsorted_blocks,
                    "hash_probe": ck.hash_probe, "bsr_spmv": sk.bsr_spmv,
                    "merge_tiles": mgk.merge_tiles,
                    "gather_rif": gk.gather_rif,
                    "ring_gather": rk.ring_gather,
                    "ring_deref": rk.ring_deref,
                    "ring_chase": rk.ring_chase}
        self.paths = {}

    def reset(self):
        for fn in self.fns.values():
            fn.launches = 0

    def read(self, path, required, expect=None):
        """The counts since ``reset``; every kernel in ``required`` must
        have launched, and each in ``expect`` exactly that many times."""
        counts = {k: fn.launches for k, fn in self.fns.items()}
        self.paths[path] = counts
        missing = [k for k in required if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{path}: kernels never launched: "
                                 f"{missing}")
        bad = {k: (counts[k], v) for k, v in (expect or {}).items()
               if counts[k] != v}
        if bad:
            raise AssertionError(f"{path}: launches (got, expected) {bad}")
        return counts


def build_full(arch, dev, **overrides):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config(arch, **overrides)
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"{arch} full width: {sum(p.numel() for p in params.parameters())} "
        f"parameters ({cfg.n_layers} layers) built in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, bundle, params


def run_granite(dev, launches, card):
    from repro_torch.runtime.serve_loop import PagedServeLoop
    cfg, bundle, params = build_full(GRANITE, dev)
    errs = check_logits(cfg, params, dev, (True,), with_step=True)
    log(f"{GRANITE} logits kernel vs plain (max |err|, limit; the plain "
        f"path replays the kernel routing): {json.dumps(errs)}")

    _, reqs = main_requests(cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    paged = PagedServeLoop(cfg, bundle, params, batch_slots=SLOTS,
                           s_max=S_MAX, chunk=CHUNK, page=PAGE)
    res, wall = serve(paged, reqs)
    counts = launches.read("granite_paged_serve",
                           ("gmm", "flash_decode_paged", "dae_gather"))
    st = paged.stats
    log(f"{GRANITE} PagedServeLoop: {sum(map(len, res.values()))} tokens, "
        f"{st.prefill_steps} prefill + {st.decode_steps} decode steps, "
        f"{wall:.2f} s; launches {json.dumps(counts)} ({card})")
    del paged

    tok = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S)), dtype=torch.int32, device=dev)
    from repro_torch.launch.steps import make_prefill_step
    step = make_prefill_step(cfg)
    step(params, {"tokens": tok[:, :64]})                 # warm the allocator
    torch.cuda.synchronize()
    launches.reset()
    t0 = time.perf_counter()
    logits = step(params, {"tokens": tok})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches.read("granite_prefill_step",
                           ("flash", "gmm", "dae_gather"))
    if tuple(logits.shape) != (PREFILL_B, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill step logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    log(f"{GRANITE} make_prefill_step: {PREFILL_B} x {PREFILL_S} tokens in "
        f"{wall:.3f} s; launches {json.dumps(counts)} ({card})")
    log(f"{GRANITE} peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB ({card})")


def run_qwen(dev, launches, card):
    from repro_torch.runtime.serve_loop import (PagedServeLoop, Request,
                                                ServeLoop)
    cfg, bundle, params = build_full(QWEN, dev)
    errs = check_logits(cfg, params, dev, (True, False), with_step=False)
    log(f"{QWEN} logits kernel vs plain (max |err|, limit): "
        f"{json.dumps(errs)}")

    prompts, reqs = main_requests(cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    paged = PagedServeLoop(cfg, bundle, params, batch_slots=SLOTS,
                           s_max=S_MAX, chunk=CHUNK, page=PAGE)
    res_p, wall_p = serve(paged, reqs)
    st = paged.stats
    steps = (st.prefill_steps, st.decode_steps)
    again = [Request(rid=100, prompt=prompts[1], max_new=MAX_NEW)]
    res_again, wall_again = serve(paged, again)
    if st.prefix_hits < 1:
        raise AssertionError("the repeated prompt reused no prefix")
    counts = launches.read("qwen3_paged_serve",
                           ("flash_decode_paged", "dae_gather"))
    phase5 = {"streams": {**res_p, **res_again}, "launches": counts,
              "stats": {k: getattr(st, k) for k in SERVE_COUNTERS}}
    log(f"{QWEN} PagedServeLoop: {sum(map(len, res_p.values()))} tokens, "
        f"{steps[0]} prefill + {steps[1]} decode steps, {wall_p:.2f} s; "
        f"repeat of a 700-token prompt {wall_again:.2f} s, "
        f"{st.prefill_steps - steps[0]} prefill + "
        f"{st.decode_steps - steps[1]} decode steps, "
        f"{st.prefix_tokens_reused} tokens reused; launches over both "
        f"{json.dumps(counts)} ({card})")
    del paged
    torch.cuda.empty_cache()

    launches.reset()
    contig = ServeLoop(cfg, bundle, params, batch_slots=SLOTS, s_max=S_MAX,
                       chunk=CHUNK)
    res_c, wall_c = serve(contig, [dataclasses.replace(r, out=None)
                                   for r in reqs])
    counts = launches.read("qwen3_contiguous_serve",
                           ("flash_decode", "dae_gather"))
    st = contig.stats
    same = sum(res_c[r] == res_p[r] for r in res_c)
    log(f"{QWEN} ServeLoop: {sum(map(len, res_c.values()))} tokens, "
        f"{st.prefill_steps} prefill + {st.decode_steps} decode steps, "
        f"{wall_c:.2f} s; {same}/{len(res_c)} streams equal to the paged "
        f"loop's; launches {json.dumps(counts)} ({card})")
    log(f"{QWEN} peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB ({card})")
    return cfg, bundle, params, phase5


# ---------------------------------------------------------------------------
# phase 13: disaggregated serving, qwen3-4b at full width
# ---------------------------------------------------------------------------


def run_mesh_serve(dev, launches, card, cfg, bundle, params, phase5):
    """Phase 13 on phase 5's qwen3-4b build and requests: (a)
    ``ShardedPagedServeLoop`` co-located on ``make_serve_meshes(1)``, the
    requests then the 700-token prompt again, its streams, the ten
    counters and the launch counts equal to phase 5's ``PagedServeLoop``;
    (b) disaggregated on ``[dev, dev]``, its streams equal to a
    ``PagedServeLoop(prefix_reuse=False)``'s, 8 migrations from a
    513-page staging pool, each migration's pages, bytes and wall (gather
    + host hop + scatter), their total and share of the loop's wall, and
    TTFT beside the baseline's."""
    from repro_torch.channels import MeshChannel
    from repro_torch.launch.mesh import make_serve_meshes
    from repro_torch.runtime.mesh_serve import ShardedPagedServeLoop
    from repro_torch.runtime.serve_loop import PagedServeLoop, Request
    t0 = time.perf_counter()
    prompts, reqs = main_requests(cfg.vocab)
    kw = dict(batch_slots=SLOTS, s_max=S_MAX, chunk=CHUNK, page=PAGE)
    out = {}

    torch.cuda.empty_cache()
    launches.reset()
    loop = ShardedPagedServeLoop(cfg, bundle, params,
                                 meshes=make_serve_meshes(1), **kw)
    res, wall = serve(loop, reqs)
    res_again, wall_again = serve(loop, [Request(
        rid=100, prompt=prompts[1], max_new=MAX_NEW)])
    counts = launches.read("qwen3_mesh1_serve",
                           ("flash_decode_paged", "dae_gather"),
                           {k: phase5["launches"][k]
                            for k in ("flash_decode_paged", "dae_gather")})
    stats = {k: getattr(loop.stats, k) for k in SERVE_COUNTERS}
    if not isinstance(loop.handoff, MeshChannel) or loop.handoff.span != 1:
        raise AssertionError("co-located handoff is not a span-1 "
                             "MeshChannel")
    if stats != phase5["stats"]:
        raise AssertionError(f"co-located counters {stats} != phase 5's "
                             f"{phase5['stats']}")
    streams = {**res, **res_again}
    same = sum(streams[r] == phase5["streams"][r] for r in streams)
    if same != len(phase5["streams"]) or set(streams) != set(
            phase5["streams"]):
        raise AssertionError(f"co-located: {same}/{len(phase5['streams'])} "
                             "streams equal to phase 5's")
    out["colocated"] = {"wall_s": round(wall, 3),
                        "repeat_wall_s": round(wall_again, 3),
                        "streams_equal": same, "counters": stats,
                        "launches": counts}
    log(f"{QWEN} phase 13 (a) co-located ShardedPagedServeLoop n=1: "
        f"{json.dumps(out['colocated'])} ({card})")
    del loop

    def expect(st):
        return {"flash_decode_paged": cfg.n_layers * st.decode_steps,
                "dae_gather": st.prefill_steps + st.decode_steps,
                "flash_decode": 0, "flash": 0, "gmm": 0}

    cells = {}
    for name, make in (
            ("paged_no_reuse", lambda: PagedServeLoop(
                cfg, bundle, params, prefix_reuse=False, **kw)),
            ("disaggregated", lambda: ShardedPagedServeLoop(
                cfg, bundle, params,
                meshes=make_serve_meshes(2, devices=[dev, dev]), **kw))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        loop = make()
        res, wall = serve(loop, [dataclasses.replace(r, out=None)
                                 for r in reqs])
        st = loop.stats
        counts = launches.read(f"qwen3_{name}_serve",
                               ("flash_decode_paged", "dae_gather"),
                               expect(st))
        cells[name] = (res, loop, wall, {
            "wall_s": round(wall, 3),
            "ttft_ms_p50_p95": _ttft_ms(st, reqs),
            "prefill_steps": st.prefill_steps,
            "decode_steps": st.decode_steps,
            "page_allocs": st.page_allocs, "migrations": st.migrations,
            "peak_gib": _peak_gib(), "launches": counts})
        del loop
    (want, _, _, base), (got, loop, wall, cell) = \
        cells["paged_no_reuse"], cells["disaggregated"]
    same = sum(got[r] == want[r] for r in want)
    if same != len(reqs):
        raise AssertionError(f"disaggregated: {same}/{len(reqs)} streams "
                             "equal to PagedServeLoop(prefix_reuse=False)'s")
    if loop.stats.migrations != len(reqs):
        raise AssertionError(f"disaggregated: {loop.stats.migrations} "
                             f"migrations, expected {len(reqs)}")
    pool = loop.cache_pf[0]["attn"]["kp"]
    if loop.n_pages_pf != 1 + SLOTS * loop.npb or pool.shape[1] != \
            loop.n_pages_pf:
        raise AssertionError(f"staging pool of {pool.shape[1]} pages")
    page_bytes = sum(v[:, :1].numel() * v.element_size()
                     for seg in loop.cache_pf for v in seg["attn"].values()
                     if v.dim() > 2)
    for m in loop.migration_log:
        if m.bytes != m.pages * page_bytes:
            raise AssertionError(f"migration of slot {m.slot}: {m.bytes} "
                                 f"bytes for {m.pages} pages")
    mig_s = sum(m.seconds for m in loop.migration_log)
    cell.update({
        "streams_equal": same,
        "staging_pages": loop.n_pages_pf,
        "staging_gib": round(loop.n_pages_pf * page_bytes / 2**30, 3),
        "page_mib": round(page_bytes / 2**20, 4),
        "migrations_pages_bytes_ms": [
            (m.pages, m.bytes, round(1e3 * m.seconds, 3))
            for m in loop.migration_log],
        "migration_ms_total": round(1e3 * mig_s, 3),
        "migration_share_of_wall": round(mig_s / wall, 4)})
    out["paged_no_reuse"], out["disaggregated"] = base, cell
    log(f"{QWEN} phase 13 (b) PagedServeLoop(prefix_reuse=False): "
        f"{json.dumps(base)} ({card})")
    log(f"{QWEN} phase 13 (b) disaggregated ShardedPagedServeLoop on "
        f"[{dev}, {dev}]: {json.dumps(cell)} ({card})")
    del loop, cells
    torch.cuda.empty_cache()
    out["phase_s"] = round(time.perf_counter() - t0, 1)
    log(f"phase 13 took {out['phase_s']} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the sharded steps on a (1, 1) rank mesh
# ---------------------------------------------------------------------------

SHARD_SERVE_STEPS = 16


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def shard_serve_phase(dev, launches, card, cfg, bundle, params):
    """Phase 15 (a), on phase 5's qwen3-4b build in a one-rank ``nccl``
    group: ``shard_prefill_step`` on 2 x 2048 and SHARD_SERVE_STEPS
    greedy ``shard_serve_step``s of 8 rows at s_max 1024 on a (1, 1)
    mesh, each bit-equal to ``make_prefill_step``/``make_serve_step``
    (logits and the cache), with ``flash`` n_layers and ``dae_gather``
    once a prefill step, ``flash_decode`` n_layers and ``dae_gather``
    once a serve step; both sides' walls."""
    import torch.distributed as dist
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel.sharding import param_shardings, place
    t_phase = time.perf_counter()
    _init_group()
    try:
        mesh = make_debug_mesh((1, 1), ("data", "model"), ranks=True)
        shards = place(params, mesh, param_shardings(params, mesh))
        if shards is not params:
            raise AssertionError("a (1, 1) mesh must keep the module")
        n = cfg.n_layers
        tok = torch.as_tensor(np.random.default_rng(15).integers(
            0, cfg.vocab, (PREFILL_B, PREFILL_S)), dtype=torch.int32,
            device=dev)
        ref = steps.make_prefill_step(cfg)
        step, _ = steps.shard_prefill_step(
            cfg, mesh, InputShape("prefill", PREFILL_S, PREFILL_B,
                                  "prefill"))
        ref(params, {"tokens": tok[:, :64]})
        step(shards, {"tokens": tok[:, :64]})
        want, wall_ref = _timed(lambda: ref(params, {"tokens": tok}))
        launches.reset()
        got, wall = _timed(lambda: step(shards, {"tokens": tok}))
        pre_counts = launches.read("qwen3_shard_prefill",
                                   ("flash", "dae_gather"),
                                   {"flash": n, "dae_gather": 1,
                                    "flash_decode": 0, "gmm": 0})
        if not torch.equal(got, want):
            raise AssertionError(
                f"shard_prefill_step: {float((got - want).abs().max())} "
                "off make_prefill_step")
        out = {"prefill": {"tokens": [PREFILL_B, PREFILL_S],
                           "wall_s": round(wall, 4),
                           "unsharded_wall_s": round(wall_ref, 4),
                           "bit_equal": True, "launches": pre_counts}}
        del got, want
        ref = steps.make_serve_step(cfg)
        step, _ = steps.shard_serve_step(
            cfg, mesh, InputShape("decode", S_MAX, SLOTS, "decode"))
        ca, cb = bundle.cache_init(SLOTS, S_MAX), bundle.cache_init(SLOTS,
                                                                   S_MAX)
        t = torch.as_tensor(np.random.default_rng(16).integers(
            0, cfg.vocab, SLOTS), dtype=torch.int32, device=dev)
        pos = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
        walls, walls_ref, total = [], [], {}
        for _ in range(SHARD_SERVE_STEPS):
            (la, ca), w_ref = _timed(lambda: ref(params, ca, t, pos))
            launches.reset()
            (lb, cb), w = _timed(lambda: step(shards, cb, t, pos))
            counts = launches.read("qwen3_shard_serve",
                                   ("flash_decode", "dae_gather"),
                                   {"flash_decode": n, "dae_gather": 1,
                                    "flash": 0, "flash_decode_paged": 0})
            for key, v in counts.items():
                total[key] = total.get(key, 0) + v
            if not torch.equal(la, lb):
                raise AssertionError(
                    f"shard_serve_step: {float((la - lb).abs().max())} off "
                    "make_serve_step")
            walls.append(w)
            walls_ref.append(w_ref)
            t, pos = la.argmax(-1).to(torch.int32), pos + 1
        launches.paths["qwen3_shard_serve"] = total
        for x, y in zip(ca, cb):
            for key in x["attn"]:
                if not torch.equal(x["attn"][key], y["attn"][key]):
                    raise AssertionError(f"shard_serve_step: cache leaf "
                                         f"{key} differs")
        k = SHARD_SERVE_STEPS
        serve_counts = {key: total[key] for key in (
            "flash_decode", "dae_gather", "flash", "gmm")}
        out["serve"] = {"steps": k, "rows": SLOTS, "s_max": S_MAX,
                        "bit_equal": True,
                        "wall_ms_median": round(1e3 * float(
                            np.median(walls[1:])), 3),
                        "unsharded_wall_ms_median": round(1e3 * float(
                            np.median(walls_ref[1:])), 3),
                        "launches": serve_counts}
        del ca, cb
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log(f"{QWEN} phase 15 (a) shard_prefill_step and shard_serve_step on a "
        f"(1, 1) rank mesh: {json.dumps(out)} ({card})")
    return out


def _train_two(step, params, state, batch):
    rows = []
    for _ in range(2):
        (params, state, m), wall = _timed(
            lambda: step(params, state, batch))
        rows.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "wall_s": round(wall, 4)})
    return rows


def _rel_diffs(rows, want):
    return [abs(r[k] - w[k]) / abs(w[k]) for r, w in zip(rows, want)
            for k in ("loss", "grad_norm")]


def shard_train_phase(dev, launches, card, phase10):
    """Phase 15 (b), after phase 10 has freed its trainer: from phase
    10's seeded start (granite-moe-3b-a800m at full depth, float32
    state, the same optimizer and batch), two steps of
    ``make_train_step`` and then two of ``shard_train_step`` on a (1, 1)
    mesh, each trainer built and freed in turn, both with
    ``torch.use_deterministic_algorithms``: the ref MoE path's float32
    ``index_add_`` (its combine, and the backward of its
    ``index_select``) adds with atomics in a run-dependent order on the
    card, so the unsharded step does not repeat its own bits (phase 10's
    first two steps are printed beside, with the distance).  The
    sharded step's loss and grad norm must equal the unsharded step's
    bit for bit, and no kernel may launch."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW
    from repro_torch.parallel.sharding import param_shardings, place
    t_phase = time.perf_counter()
    cfg = get_config(GRANITE, kernel_mode="ref")
    batch = SyntheticLM(cfg.vocab, TRAIN_S, TRAIN_B).batch_at(0)
    shape = InputShape("train", TRAIN_S, TRAIN_B, "train")

    def start():
        params = build_model(cfg).init(
            torch.Generator(device=dev).manual_seed(0), dtype=cfg.pdtype)
        opt = AdamW(lr=TRAIN_LR)
        return params, opt, opt.init(params)

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    _init_group()
    try:
        params, opt, state = start()
        want = _train_two(steps.make_train_step(cfg, opt), params, state,
                          batch)
        del params, state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = make_debug_mesh((1, 1), ("data", "model"), ranks=True)
        params, opt, state = start()
        params = place(params, mesh, param_shardings(params, mesh))
        step, _ = steps.shard_train_step(cfg, mesh, shape, optimizer=opt)
        launches.reset()
        rows = _train_two(step, params, state, batch)
        counts = launches.read("granite_shard_train", (),
                               {k: 0 for k in launches.fns})
        if _rel_diffs(rows, want) != [0.0] * 4:
            raise AssertionError(f"shard_train_step {rows} against "
                                 f"make_train_step's {want}")
        out = {"steps": rows, "unsharded": want, "bit_equal": True,
               "phase10": phase10,
               "phase10_rel_diff_max": max(_rel_diffs(want, phase10)),
               "peak_gib": _peak_gib(), "launches": counts}
        del params, state
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(was)
    torch.cuda.empty_cache()
    out["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log(f"{GRANITE} phase 15 (b) shard_train_step on a (1, 1) rank mesh: "
        f"{json.dumps(out)} ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 14: one serving engine over ranks (a world of one), parallel/
# ---------------------------------------------------------------------------


def _init_group():
    """A one-rank ``nccl`` group in this process, on this card."""
    import inspect
    import torch.distributed as dist
    kw = {}
    if "device_id" in inspect.signature(dist.init_process_group).parameters:
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, **kw)


def _event_ms(fn, reps: int = 10) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rank_serve(launches, card, cfg, bundle, params, phase5):
    """Phase 14 (a): ``ShardedPagedServeLoop`` on a one-rank mesh, phase
    5's requests and the prompt again, held to phase 5's streams,
    counters and launches; the pool bytes each step gathers and the
    device ms of one step's gathers and keep-backs."""
    from repro_torch.launch.mesh import make_serve_meshes
    from repro_torch.parallel.sharding import (gather_pool, keep_shard,
                                               pool_shards)
    from repro_torch.runtime.mesh_serve import ShardedPagedServeLoop
    from repro_torch.runtime.serve_loop import Request
    prompts, reqs = main_requests(cfg.vocab)
    torch.cuda.empty_cache()
    launches.reset()
    meshes = make_serve_meshes(ranks=True)
    loop = ShardedPagedServeLoop(cfg, bundle, params, meshes=meshes,
                                 batch_slots=SLOTS, s_max=S_MAX, chunk=CHUNK,
                                 page=PAGE)
    res, wall = serve(loop, reqs)
    res_again, wall_again = serve(loop, [Request(
        rid=100, prompt=prompts[1], max_new=MAX_NEW)])
    counts = launches.read("qwen3_rank1_serve",
                           ("flash_decode_paged", "dae_gather"),
                           {k: phase5["launches"][k]
                            for k in ("flash_decode_paged", "dae_gather")})
    stats = {k: getattr(loop.stats, k) for k in SERVE_COUNTERS}
    if stats != phase5["stats"]:
        raise AssertionError(f"rank mesh counters {stats} != phase 5's "
                             f"{phase5['stats']}")
    streams = {**res, **res_again}
    same = sum(streams[r] == phase5["streams"][r] for r in streams)
    if same != len(phase5["streams"]) or set(streams) != set(
            phase5["streams"]):
        raise AssertionError(f"rank mesh: {same}/{len(phase5['streams'])} "
                             "streams equal to phase 5's")
    if not loop._split["execute"]:
        raise AssertionError("a one-rank pool must shard one way")
    leaves = [v for seg in loop.cache for v in seg["attn"].values()
              if v.dim() > 2]
    pool_bytes = sum(v.numel() * v.element_size() for v in leaves)
    lcfg = loop.bundle.cfg

    def one_step():
        # what a step's layers do to the pool besides attending it:
        # gather each layer's leaf whole and keep its slice back
        with pool_shards(meshes.decode):
            for v in leaves:
                for i in range(v.shape[0]):
                    keep_shard(lcfg, v[i], gather_pool(lcfg, v[i]))
    step_ms = _event_ms(one_step, reps=5)
    out = {"wall_s": round(wall, 3), "repeat_wall_s": round(wall_again, 3),
           "streams_equal": same, "counters": stats, "launches": counts,
           "pool_bytes_per_rank": pool_bytes,
           "gathered_bytes_per_step": pool_bytes,
           "gather_keep_ms_per_step": round(step_ms, 4)}
    log(f"{QWEN} phase 14 (a) ShardedPagedServeLoop on a one-rank nccl "
        f"mesh: {json.dumps(out)} ({card})")
    del loop
    torch.cuda.empty_cache()
    return out


def rank_ep_moe(dev, card):
    """Phase 14 (b): ``make_ep_moe`` on a (1, 1) rank mesh with
    granite-moe-3b-a800m's layer-0 experts at full width (seeded), 256
    tokens, dropless, against ``ep_moe_reference`` on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.moe import MoE
    from repro_torch.parallel import ep_moe_reference, make_ep_moe
    gcfg = get_config(GRANITE)
    gen = torch.Generator(device=dev).manual_seed(14)
    moe = MoE(gcfg, dev, gen)
    e, k, tokens = gcfg.n_experts, gcfg.top_k, 256
    ws = [w[:e] for w in (moe.w_gate, moe.w_up, moe.w_down)]
    x = torch.randn((tokens, gcfg.d_model), generator=gen, device=dev,
                    dtype=moe.router.dtype)
    mesh = make_debug_mesh((1, 1), ("data", "model"), ranks=True)
    fn = make_ep_moe(mesh, top_k=k, n_experts=e,
                     capacity_per_shard=tokens * k)
    with torch.inference_mode():
        got = fn(x, moe.router, *ws)
        want = ep_moe_reference(x, moe.router, *ws, k)
        err = assert_close_bf16("make_ep_moe", got, want)
        ms = _event_ms(lambda: fn(x, moe.router, *ws))
        ref_ms = _event_ms(lambda: ep_moe_reference(x, moe.router, *ws, k))
    out = {"experts": e, "top_k": k, "d": gcfg.d_model,
           "f": int(ws[0].shape[-1]), "tokens": tokens, "max_abs_err": err,
           "ms": round(ms, 4), "reference_ms": round(ref_ms, 4)}
    log(f"{GRANITE} phase 14 (b) make_ep_moe on (1, 1), dropless, against "
        f"ep_moe_reference (bf16 limit): {json.dumps(out)} ({card})")
    del moe, ws, got, want
    return out


def rank_compress_pp(dev, card, cfg, params):
    """Phase 14 (c) ``compressed_grad_mean`` over one qwen3-4b layer's
    weights in float32 as gradients: mean + residual within 1e-6 of
    them; (d) ``pipeline_forward`` with one stage at qwen3's width
    against the stage applied directly."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import compressed_grad_mean, pipeline_forward
    mesh = make_debug_mesh((1,), ("data",), ranks=True)
    with torch.inference_mode():
        layer = params.segments[0][0]
        grads = {n: p.detach().float() for n, p in layer.named_parameters()}
        res = {n: torch.zeros_like(g) for n, g in grads.items()}
        mean, new_res = compressed_grad_mean(grads, res, mesh, "data")
        err = max(float((mean[n] + new_res[n] - g).abs().max())
                  for n, g in grads.items())
        if err > 1e-6:
            raise AssertionError(f"compressed_grad_mean: mean + residual "
                                 f"{err} off the gradients")
        ms = _event_ms(lambda: compressed_grad_mean(grads, res, mesh,
                                                    "data"), reps=3)
        n_el = sum(g.numel() for g in grads.values())
        del mean, new_res, grads, res
        stage = make_debug_mesh((1,), ("stage",), ranks=True)
        gen = torch.Generator(device=dev).manual_seed(15)
        d = cfg.d_model
        ws = torch.randn((1, d, d), generator=gen, device=dev) / d ** 0.5
        x = torch.randn((4, SLOTS, d), generator=gen, device=dev)
        got = pipeline_forward(lambda w, a: torch.tanh(a @ w), ws, x, stage,
                               axis="stage")
        pp_err = float((got - torch.tanh(x @ ws[0])).abs().max())
        if pp_err > 2e-5:
            raise AssertionError(f"pipeline_forward: {pp_err} off")
    out = {"compress": {"elements": n_el, "max_abs_err": err,
                        "ms": round(ms, 3)},
           "pipeline": {"stages": 1, "microbatches": 4, "d": d,
                        "max_abs_err": pp_err}}
    log(f"{QWEN} phase 14 (c, d) compressed_grad_mean and pipeline_forward "
        f"on one rank: {json.dumps(out)} ({card})")
    return out


def run_rank_phase(dev, launches, card, cfg, bundle, params, phase5):
    """Phase 14 on phase 5's qwen3-4b build, in a one-rank ``nccl``
    group that is destroyed at the end, so later phases run without
    one."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    _init_group()
    try:
        out = {"serve": rank_serve(launches, card, cfg, bundle, params,
                                   phase5),
               "ep_moe": rank_ep_moe(dev, card),
               **rank_compress_pp(dev, card, cfg, params)}
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["phase_s"] = round(time.perf_counter() - t0, 1)
    log(f"phase 14 took {out['phase_s']} s")
    return out


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > reach:
            total += hi - max(lo, reach)
            reach = hi
    return total


def trace_decode_steps(cfg, loop, launches, requests, card, path: str,
                       decode_launches: int, n: int = 3):
    """Serve ``requests`` on ``loop`` (a serve loop that may have served
    before) and trace its decode steps 2..n+1 with ``torch.profiler``
    (CPU and CUDA activity): each step is one real ``_step`` call (the
    arguments' copies to the card, ``lm_prefill`` over every slot, the
    logits' copy back).  ``flash_decode`` must launch
    ``decode_launches`` times a decode step.  Prints the traced steps'
    host wall, the device's busy time in them (the union of its kernels'
    and copies' intervals) and its idle share, device operations a step,
    device ms by kernel name, and the mean wall of the same run's
    untraced decode steps; returns the numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    inner, walls = loop._step, []
    live = []

    def step(tok, n_valid):
        if tok.shape[1] != 1:                       # a prefill chunk
            return inner(tok, n_valid)
        k = len(walls)
        if k == 1:
            prof.start()
        t0 = time.perf_counter()
        if 1 <= k <= n:
            live.append(int(np.count_nonzero(n_valid)))
            with record_function("decode_step"):
                out = inner(tok, n_valid)
        else:
            out = inner(tok, n_valid)
        walls.append(time.perf_counter() - t0)      # ends in a D2H copy
        if k == n:
            prof.stop()
        return out

    loop._step = step
    launches.reset()
    try:
        serve(loop, requests)
    finally:
        del loop._step
    counts = launches.read(path, (), {
        "flash_decode": decode_launches * len(walls),
        "flash_decode_paged": 0})
    events = prof.events()
    windows = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == "decode_step" and e.device_type == DeviceType.CPU]
    # the range's own mark on the device timeline is no device work
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name != "decode_step"]
    span = sum(hi - lo for lo, hi in windows)
    untraced = [w for k, w in enumerate(walls) if not 1 <= k <= n]
    untraced_ms = 1e3 * sum(untraced) / len(untraced)
    head = (f"{cfg.arch} {n} traced decode steps (B {loop.b}, "
            f"{loop.s_max} tokens a slot, {min(live)}-{max(live)} slots "
            f"decoding): wall {span / n / 1e3:.3f} ms a step under the "
            f"profiler, {untraced_ms:.3f} ms untraced (mean of "
            f"{len(untraced)} in the same run)")
    if not device:
        log(f"{head}; the profiler recorded no device events ({card})")
        return {"traced_ms": span / n / 1e3, "untraced_ms": untraced_ms}
    busy, by_name, ops = 0.0, {}, 0
    for lo, hi in windows:
        inside = [(max(e.time_range.start, lo), min(e.time_range.end, hi),
                   e.name) for e in device
                  if e.time_range.end > lo and e.time_range.start < hi]
        busy += _union_us((a, b) for a, b, _ in inside)
        ops += len(inside)
        for a, b, name in inside:
            t, c = by_name.get(name[:96], (0.0, 0))
            by_name[name[:96]] = (t + b - a, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    extra = ""
    if cfg.attn_kind == "mla":
        flops = 2 * loop.b * loop.s_max * cfg.kv_lora_rank * cfg.n_heads * (
            cfg.qk_nope + cfg.v_hd)
        extra = (f"; up-projection {flops / 1e9:.1f} GFLOP a layer, "
                 f"{flops * cfg.n_layers / 1e12:.2f} TFLOP a step")
    log(f"{head}; device busy {busy / n / 1e3:.3f} ms a step, idle "
        f"{100 * (1 - busy / span):.1f} % of the traced window, "
        f"{ops / n:.0f} device operations a step; busy over the untraced "
        f"wall {100 * busy / n / 1e3 / untraced_ms:.1f} %; device ms a "
        "step by kernel name (its first 96 characters), with its count a "
        "step: "
        + json.dumps([[name, round(t / n / 1e3, 4), c // n]
                      for name, (t, c) in top[:12]])
        + f"; the other {len(top) - 12} names "
        f"{sum(t for _, (t, _) in top[12:]) / n / 1e3:.4f} ms"
        + f"{extra}; launches {json.dumps(counts)} ({card})")
    return {"traced_ms": span / n / 1e3, "untraced_ms": untraced_ms,
            "busy_ms": busy / n / 1e3, "idle_pct": 100 * (1 - busy / span),
            "ops": ops / n}


def run_mla(dev, launches, card, arch, tag, trace: bool = False):
    """An MLA model at full width (minicpm3-4b, deepseek-v2-lite-16b):
    its decodes run the contiguous ``flash_decode`` (G 1, D = dn + dr)
    on the latent gathered and up-projected at every step, on the paged
    path too, so ``flash_decode_paged`` must not launch; its cache-free
    forward runs ``flash`` at D = dn + dr.  An MoE model's expert layers
    launch ``gmm`` three times each a step (gate, up, down), prefill and
    decode steps alike, and the two loops must serve equal streams.
    ``trace``: three paged decode steps under ``torch.profiler``.  Path
    names start with ``tag``."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.runtime.serve_loop import (PagedServeLoop, Request,
                                                ServeLoop)
    cfg, bundle, params = build_full(arch, dev)
    moe_layers = sum(sp.count for sp in cfg.layer_specs() if sp.kind == "moe")
    errs = check_logits(cfg, params, dev, (True, False), with_step=True)
    log(f"{arch} logits kernel vs plain (max |err|, limit; the plain path "
        f"replays the kernel routing): {json.dumps(errs)}")

    def read(path, st, before=(0, 0)):
        """The path's launches over the steps ``st`` took since
        ``before`` (prefill, decode steps)."""
        pre, dec = (st.prefill_steps - before[0],
                    st.decode_steps - before[1])
        need = ("flash_decode", "dae_gather") + (("gmm",) if moe_layers
                                                 else ())
        return launches.read(path, need, {
            "flash_decode": cfg.n_layers * dec, "flash_decode_paged": 0,
            "dae_gather": pre + dec, "gmm": 3 * moe_layers * (pre + dec)})

    prompts, reqs = main_requests(cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    paged = PagedServeLoop(cfg, bundle, params, batch_slots=SLOTS,
                           s_max=S_MAX, chunk=CHUNK, page=PAGE)
    res_p, wall_p = serve(paged, reqs)
    st = paged.stats
    steps = (st.prefill_steps, st.decode_steps)
    counts = read(f"{tag}_paged_serve", st)
    log(f"{arch} PagedServeLoop: {sum(map(len, res_p.values()))} tokens, "
        f"{steps[0]} prefill + {steps[1]} decode steps, {wall_p:.2f} s, "
        f"{wall_p / (steps[0] + steps[1]) * 1e3:.1f} ms a step; launches "
        f"{json.dumps(counts)} ({card})")
    launches.reset()
    again = [Request(rid=100, prompt=prompts[1], max_new=MAX_NEW)]
    _, wall_again = serve(paged, again)
    if st.prefix_hits < 1:
        raise AssertionError("the repeated prompt reused no latent prefix")
    counts = read(f"{tag}_paged_again", st, steps)
    log(f"{arch} repeat of a 700-token prompt {wall_again:.2f} s, "
        f"{st.prefill_steps - steps[0]} prefill + "
        f"{st.decode_steps - steps[1]} decode steps, "
        f"{st.prefix_tokens_reused} tokens reused from latent pages; "
        f"launches {json.dumps(counts)} ({card})")
    log(f"{arch} paged serve peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    if trace:
        trace_decode_steps(cfg, paged, launches,
                           [Request(rid=200, prompt=prompts[2], max_new=7)],
                           card, "minicpm3_paged_traced", cfg.n_layers)
    del paged
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    contig = ServeLoop(cfg, bundle, params, batch_slots=SLOTS, s_max=S_MAX,
                       chunk=CHUNK)
    res_c, wall_c = serve(contig, [dataclasses.replace(r, out=None)
                                   for r in reqs])
    st = contig.stats
    counts = read(f"{tag}_contiguous_serve", st)
    same = sum(res_c[r] == res_p[r] for r in res_c)
    log(f"{arch} ServeLoop: {sum(map(len, res_c.values()))} tokens, "
        f"{st.prefill_steps} prefill + {st.decode_steps} decode steps, "
        f"{wall_c:.2f} s; {same}/{len(res_c)} streams equal to the paged "
        f"loop's; launches {json.dumps(counts)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    if moe_layers and same != len(res_c):
        raise AssertionError(f"{arch}: {same}/{len(res_c)} streams equal "
                             "across the paged and contiguous loops")
    del contig
    torch.cuda.empty_cache()

    tok = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S)), dtype=torch.int32, device=dev)
    step = make_prefill_step(cfg)
    step(params, {"tokens": tok[:, :64]})                 # warm the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.perf_counter()
    logits = step(params, {"tokens": tok})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches.read(f"{tag}_prefill_step", ("flash", "dae_gather"),
                           {"flash": cfg.n_layers, "gmm": 3 * moe_layers})
    if tuple(logits.shape) != (PREFILL_B, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill step logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    log(f"{arch} make_prefill_step: {PREFILL_B} x {PREFILL_S} tokens in "
        f"{wall:.3f} s; launches {json.dumps(counts)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")


# ---------------------------------------------------------------------------
# phase 6: the paper's irregular suite
# ---------------------------------------------------------------------------


def exact_row(name, source, replaces, got, want, timer, kernel, plain,
              nbytes, library=None, library_name=""):
    """A kernel row for an integer kernel: its result must equal its plain
    version's; both are timed with the library call, if any."""
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{name}: kernel differs from plain at {bad} "
                             "positions")
    b_ms, b_by = bound(nbytes, 0)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": 0.0, "limit": "0, exact",
            "ms": timer(kernel),
            "plain_ms": timer(plain, iters=10), "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None if library is None else timer(library),
            "library": library_name}


def irregular_binsearch(dev, timer, launches, card):
    """decoupled_searchsorted over binsearch_data."""
    from repro_torch.bench import binsearch_data
    from repro_torch.core import decouple as dec
    from repro_torch.kernels.common import ring_rif
    from repro_torch.kernels.dae_chase import kernel as ck
    table, keys = binsearch_data(dev)
    n, m, block = table.shape[0], keys.shape[0], 128
    launches.reset()
    got = dec.decoupled_searchsorted(table, keys)
    torch.cuda.synchronize()
    counts = launches.read("irregular_binsearch", ("searchsorted_blocks",))
    if not torch.equal(got, torch.searchsorted(table, keys, right=True)
                       .to(torch.int32)):
        raise AssertionError("decoupled_searchsorted differs from "
                             "torch.searchsorted")
    tiles = table.view(-1, block)
    blk = (torch.searchsorted(tiles[:, 0].contiguous(), keys, right=True)
           - 1).clamp_(0, tiles.shape[0] - 1).to(torch.int32)
    distinct = int(torch.unique(blk).numel())
    op_ms = timer(lambda: dec.decoupled_searchsorted(table, keys))
    # the op's parts (kernels/dae_chase/ops.py): the summary gather and
    # the summary search in plain torch, then the kernel
    summary = tiles[:, 0].contiguous()
    gather_ms = timer(lambda: tiles[:, 0].contiguous())
    search_ms = timer(lambda: (torch.searchsorted(summary, keys, right=True)
                               - 1).clamp_(0, tiles.shape[0] - 1)
                      .to(torch.int32))
    row = exact_row(
        "searchsorted_blocks", "src/repro_torch/csrc/dae_chase.cu",
        "src/repro/kernels/dae_chase/kernel.py:70",
        ck.searchsorted_blocks(tiles, blk, keys, n),
        ck.searchsorted_blocks_plain(tiles, blk, keys, n), timer,
        lambda: ck.searchsorted_blocks(tiles, blk, keys, n),
        lambda: ck.searchsorted_blocks_plain(tiles, blk, keys, n),
        distinct * block * 4 + 3 * m * 4,
        lambda: torch.searchsorted(table, keys, right=True),
        " (torch.searchsorted)")
    plan = ck.search_plan(block, m, 64, ring_rif(None, block * 4))
    log(f"irregular_binsearch: {m} keys in {n} int32, {distinct} distinct "
        f"blocks of {block}; searchsorted_blocks reads units of "
        f"{ck.SEARCH_UNIT_BYTES} B, at most {plan.levels} a key, "
        f"{plan.kpt} keys a lane group in flight, {plan.ctas} one-warp "
        f"CTAs; "
        f"decoupled_searchsorted {op_ms:.4f} ms = summary gather "
        f"{gather_ms:.4f} + summary search {search_ms:.4f} + kernel "
        f"{row['ms']:.4f} (each under the cold timer); launches "
        f"{json.dumps(counts)} ({card})")
    return row


def irregular_hashtable(dev, timer, launches, card):
    """2^20 lookups over 2^24 entries in chains of 16, each entry at a
    seeded random slot; random chain and depth, 1/8 misses."""
    from repro_torch.core import decouple as dec
    from repro_torch.kernels.dae_chase import kernel as ck
    from repro_torch.kernels.dae_chase.ops import pack_entries
    gen = torch.Generator(device=dev).manual_seed(62)
    n, chain, m = 1 << 24, 16, 1 << 20
    slot = torch.randperm(n, generator=gen, device=dev)   # entry e at slot[e]
    e = torch.arange(n, device=dev)
    ek = torch.empty(n, dtype=torch.int32, device=dev)
    ev, en = torch.empty_like(ek), torch.empty_like(ek)
    ek[slot] = e.to(torch.int32)
    ev[slot] = torch.randint(0, 2 ** 31 - 1, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
    en[slot] = torch.where(e % chain == chain - 1, -1,
                           slot[(e + 1).clamp(max=n - 1)]).to(torch.int32)
    c = torch.randint(0, n // chain, (m,), generator=gen, device=dev)
    d = torch.randint(0, chain, (m,), generator=gen, device=dev)
    miss = torch.rand((m,), generator=gen, device=dev) < 0.125
    heads = slot[c * chain].to(torch.int32)
    keys = torch.where(miss, -1, c * chain + d).to(torch.int32)
    want = torch.where(miss, -1, ev[slot[c * chain + d]])
    launches.reset()
    got = dec.decoupled_hash_lookup(ek, ev, en, heads, keys, max_steps=chain)
    torch.cuda.synchronize()
    counts = launches.read("irregular_hashtable", ("hash_probe",))
    if not torch.equal(got, want):
        raise AssertionError("decoupled_hash_lookup returned wrong values")
    # entries the walks need: per chain, down to the deepest lookup's depth
    reach = torch.zeros(n // chain, dtype=torch.int64, device=dev)
    reach.scatter_reduce_(0, c, torch.where(miss, chain, d + 1), "amax")
    visited = int(reach.sum())
    packed = pack_entries(ek, ev, en)
    op_ms = timer(lambda: dec.decoupled_hash_lookup(ek, ev, en, heads, keys,
                                                    max_steps=chain))
    row = exact_row(
        "hash_probe", "src/repro_torch/csrc/dae_chase.cu",
        "src/repro/kernels/dae_chase/kernel.py:160",
        ck.hash_probe(packed, heads, keys, max_steps=chain),
        ck.hash_probe_plain(packed, heads, keys, max_steps=chain), timer,
        lambda: ck.hash_probe(packed, heads, keys, max_steps=chain),
        lambda: ck.hash_probe_plain(packed, heads, keys, max_steps=chain),
        visited * ck.ENTRY_WORDS * 4 + 3 * m * 4)
    walked = int(torch.where(miss, chain, d + 1).sum())
    log(f"irregular_hashtable: {m} lookups ({int(miss.sum())} misses) over "
        f"{n} entries in chains of {chain}; {walked} entry loads, {visited} "
        f"distinct entries; decoupled_hash_lookup (with packing) {op_ms:.4f} "
        f"ms; no library call does a chained lookup; launches "
        f"{json.dumps(counts)} ({card})")
    return row


def irregular_spmv(dev, timer, launches, card):
    """A 65,536 x 2^24 CSR matrix with 8 seeded entries a row (nnz 2^19)
    through csr_to_bsr at 8 x 128, times a seeded 2^24 vector."""
    from repro_torch.core import decouple as dec
    from repro_torch.kernels.dae_spmv import kernel as sk
    nrows, ncols, per_row = 65_536, 1 << 24, 8
    nnz = nrows * per_row
    rng = np.random.default_rng(63)
    rows = np.arange(0, nnz + 1, per_row, dtype=np.int64)
    cols = rng.integers(0, ncols, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    t0 = time.perf_counter()
    vb, ri, ci, _, nrb = dec.csr_to_bsr(rows, cols, val, ncols)
    convert_s = time.perf_counter() - t0
    val_blocks = torch.from_numpy(vb).to(dev)
    del vb
    row_ids, col_ids = torch.from_numpy(ri).to(dev), torch.from_numpy(ci).to(dev)
    vec = torch.randn(ncols, generator=torch.Generator(device=dev)
                      .manual_seed(63), device=dev)
    nb, bm, bk = val_blocks.shape
    launches.reset()
    got = dec.decoupled_spmv(val_blocks, row_ids, col_ids, vec, nrb)
    torch.cuda.synchronize()
    counts = launches.read("irregular_spmv", ("bsr_spmv",))
    rows_t, cols_t = torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)
    val_t = torch.from_numpy(val).to(dev)
    csr = torch.sparse_csr_tensor(rows_t, cols_t, val_t, size=(nrows, ncols))
    row_of = torch.arange(nrows, device=dev).repeat_interleave(per_row)
    limit = 1e-5 * float(torch.zeros(nrows, dtype=torch.float64, device=dev)
                         .index_add_(0, row_of, (val_t * vec[cols_t]).abs()
                                     .double()).max())
    lib_err = float((got[:nrows] - csr @ vec).abs().max())
    if lib_err > limit:
        raise AssertionError(f"decoupled_spmv vs the CSR library product: "
                             f"max |err| {lib_err} > {limit}")
    tiles = vec.view(-1, bk)
    kern = sk.bsr_spmv(val_blocks, row_ids, col_ids, tiles, nrb)
    plain = sk.bsr_spmv_plain(val_blocks, row_ids, col_ids, tiles, nrb)
    err = float((kern - plain).abs().max())
    if err > limit:
        raise AssertionError(f"bsr_spmv vs plain: max |err| {err} > {limit}")
    tiles_used = int(torch.unique(col_ids).numel())
    bsr_call, bsr_note = _bsr_yardstick(val_blocks, row_ids, col_ids, vec,
                                        nrb, got[:nrb * bm], limit)
    op_ms = timer(lambda: dec.decoupled_spmv(val_blocks, row_ids, col_ids,
                                             vec, nrb))
    b_ms, b_by = bound(val_blocks.numel() * 4 + tiles_used * bk * 4
                       + 2 * nb * 4 + nrb * bm * 4, 2.0 * val_blocks.numel())
    csr_ms = timer(lambda: csr @ vec)
    log(f"irregular_spmv: {nrows} x {ncols}, nnz {nnz}; csr_to_bsr "
        f"{convert_s:.2f} s -> {nb} blocks of {bm} x {bk} "
        f"({val_blocks.numel() * 4 / 2**30:.2f} GiB), {tiles_used} vector "
        f"tiles used; decoupled_spmv {op_ms:.4f} ms; max |err| kernel vs "
        f"plain {err}, op vs CSR library "
        f"{lib_err} (limit {limit}); the library on the same BSR input: "
        f"{bsr_note}; cuSPARSE on the CSR input (sparse_csr_tensor @ vec) "
        f"{csr_ms:.4f} ms; launches {json.dumps(counts)} ({card})")
    return {"name": "bsr_spmv", "route": "cuda",
            "source": "src/repro_torch/csrc/dae_spmv.cu",
            "replaces": "src/repro/kernels/dae_spmv/kernel.py:59",
            "max_abs_err": err, "limit": f"{limit} = 1e-5 x max row sum",
            "ms": timer(lambda: sk.bsr_spmv(val_blocks, row_ids, col_ids,
                                            tiles, nrb)),
            "plain_ms": timer(lambda: sk.bsr_spmv_plain(
                val_blocks, row_ids, col_ids, tiles, nrb), iters=10),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if bsr_call is None else timer(bsr_call),
            "library": f" (sparse_bsr_tensor @ vec on the same 8 x 128 "
                       f"blocks: {bsr_note}; cuSPARSE on the CSR input "
                       f"{csr_ms:.4f})"}


def _bsr_yardstick(val_blocks, row_ids, col_ids, vec, nrb, got, limit):
    """The PyTorch call on the kernel's own input: ``sparse_bsr_tensor``
    over the blocks, times the vector.  Returns (the call, a note), or
    (None, the refusal quoted) where this PyTorch cannot run it."""
    nb, bm, bk = val_blocks.shape
    crow = torch.zeros(nrb + 1, dtype=torch.int64, device=vec.device)
    crow[1:] = torch.cumsum(torch.bincount(row_ids.long(), minlength=nrb), 0)
    try:
        bsr = torch.sparse_bsr_tensor(crow, col_ids.long(), val_blocks,
                                      size=(nrb * bm, vec.shape[0]))

        def call():
            return bsr @ vec[:, None]
        want = call()[:, 0]
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        msg = " ".join(str(e).split())[:300]
        return None, f"refused ({type(e).__name__}: {msg})"
    err = float((want - got).abs().max())
    if err > limit:
        raise AssertionError(f"sparse_bsr_tensor @ vec vs decoupled_spmv: "
                             f"max |err| {err} > {limit}")
    return call, f"agrees within {err}"


def irregular_mergesort(dev, timer, launches, card):
    """decoupled_merge_sort of 2^24 seeded int32 at tile 256, and one
    decoupled_merge of two sorted 2^23 runs."""
    from repro_torch.core import decouple as dec
    from repro_torch.kernels.dae_merge import kernel as mgk
    from repro_torch.kernels.dae_merge.ops import merge_path_splits
    gen = torch.Generator(device=dev).manual_seed(64)
    n, tile = 1 << 24, 256
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                      device=dev, dtype=torch.int32)
    half = n // 2
    a = torch.sort(torch.randint(0, 1 << 26, (half,), generator=gen,
                                 device=dev, dtype=torch.int32)).values
    b = torch.sort(torch.randint(0, 1 << 26, (half,), generator=gen,
                                 device=dev, dtype=torch.int32)).values
    launches.reset()
    got = dec.decoupled_merge_sort(x, tile=tile)
    torch.cuda.synchronize()
    sort_launches = launches.fns["merge_tiles"].launches
    merged = dec.decoupled_merge(a, b, tile=tile)
    torch.cuda.synchronize()
    counts = launches.read("irregular_mergesort", ("merge_tiles",))
    passes = (n // tile - 1).bit_length()
    if sort_launches != passes:
        raise AssertionError(f"merge sort launched merge_tiles "
                             f"{sort_launches} times for {passes} passes")
    if not torch.equal(got, torch.sort(x).values):
        raise AssertionError("decoupled_merge_sort differs from torch.sort")
    ab = torch.cat([a, b])
    if not torch.equal(merged, torch.sort(ab).values):
        raise AssertionError("decoupled_merge differs from torch.sort")
    n_tiles = n // tile
    ia, ib = merge_path_splits(a, b, tile, n_tiles)
    ea, eb = torch.full_like(ia, half), torch.full_like(ib, half)
    wall_ms, pass_ms = timed_sort_passes(x, tile)
    sort_ms = timer(lambda: dec.decoupled_merge_sort(x, tile=tile), iters=5)
    merge_ms = timer(lambda: dec.decoupled_merge(a, b, tile=tile))
    lib_sort_ms = timer(lambda: torch.sort(x))
    dst = torch.empty_like(x)
    copy_ms = timer(lambda: dst.copy_(x))
    row = exact_row(
        "merge_tiles", "src/repro_torch/csrc/dae_merge.cu",
        "src/repro/kernels/dae_merge/kernel.py:72",
        mgk.merge_tiles(a, b, ia, ea, ib, eb, n, tile=tile),
        mgk.merge_tiles_plain(a, b, ia, ea, ib, eb, n, tile=tile), timer,
        lambda: mgk.merge_tiles(a, b, ia, ea, ib, eb, n, tile=tile),
        lambda: mgk.merge_tiles_plain(a, b, ia, ea, ib, eb, n, tile=tile),
        2 * n * 4 + 4 * n_tiles * 4, lambda: torch.sort(ab),
        " (torch.sort of the two runs)")
    log(f"irregular_mergesort: one decoupled_merge_sort, host wall "
        f"{wall_ms:.3f} ms; its {len(pass_ms)} merge_tiles launches (each "
        f"between its own CUDA events, L2 warm from the step before) "
        f"{' '.join(f'{t:.4f}' for t in pass_ms)} ms, sum "
        f"{sum(pass_ms):.4f} ms, {100 * sum(pass_ms) / wall_ms:.1f} % of "
        f"the wall; the rest is the tile sort and the passes' split search "
        f"({card})")
    log(f"irregular_mergesort: decoupled_merge_sort of {n} int32 at tile "
        f"{tile}: {sort_launches} merge_tiles launches ({passes} passes), "
        f"{sort_ms:.3f} ms, torch.sort {lib_sort_ms:.3f} ms, a "
        f"device-to-device copy of the {n} int32 {copy_ms:.4f} ms; one "
        f"decoupled_merge of two sorted {half}-element runs {merge_ms:.3f} "
        f"ms; launches "
        f"{json.dumps(counts)} ({card})")
    return row


def timed_sort_passes(x, tile):
    """The host wall of one decoupled_merge_sort of ``x``; then a second
    run with each merge_tiles launch between its own CUDA events, the
    device spinning before each start event (as ColdTimer does) so that
    the host's enqueueing stays outside them: (wall ms, [kernel ms by
    pass], L2 warm from the pass before)."""
    import types
    from repro_torch.bench.timing import SLEEP_CYCLES
    from repro_torch.core import decouple as dec
    from repro_torch.kernels.dae_merge import ops as mops
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec.decoupled_merge_sort(x, tile=tile)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    kernels = mops._k
    events = []

    def timed(*args, **kwargs):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SLEEP_CYCLES)
        s.record()
        out = kernels.merge_tiles(*args, **kwargs)
        e.record()
        events.append((s, e))
        return out

    mops._k = types.SimpleNamespace(merge_tiles=timed)
    try:
        dec.decoupled_merge_sort(x, tile=tile)
        torch.cuda.synchronize()
    finally:
        mops._k = kernels
    return wall, [s.elapsed_time(e) for s, e in events]


def run_irregular(dev, launches, card):
    from repro_torch.bench import ColdTimer
    timer = ColdTimer(dev)
    rows = []
    for path in (irregular_binsearch, irregular_hashtable, irregular_spmv,
                 irregular_mergesort):
        t0 = time.perf_counter()
        rows.append(path(dev, timer, launches, card))
        torch.cuda.empty_cache()
        log(f"{path.__name__}: {time.perf_counter() - t0:.1f} s")
    for r in rows:
        log(row_line(r, card))
    return rows

# ---------------------------------------------------------------------------
# phase 7: the DAE compiler and the explicit-ring kernels
# ---------------------------------------------------------------------------

# int32 ops/s: 132 SMs x 64 INT32 lanes (H100 architecture whitepaper, the
# SM) x 1.98 GHz, the clock at which 128 FP32 lanes give the data sheet's
# 67 TFLOP/s float32 (an FMA counted as two operations)
INT32_OPS = 132 * 64 * 1.98e9
RING_PORT = (1 << 24, 32)               # ring_gather / ring_deref data port
RING_ITEMS = 1 << 22


# the ring kernel each compile target runs
COMPILED_KERNEL = {"gather": "ring_gather", "frontier_gather": "ring_deref",
                   "spmv_gather": "ring_deref", "binsearch": "ring_chase",
                   "binsearch_for": "ring_chase"}


def distinct_rows(idx) -> int:
    return int(torch.unique(idx).numel())


def chase_builds(since):
    """Seconds of the chase kernels built since the snapshot ``since`` of
    ``GENERATED_BUILDS`` (nothing when every program was cached)."""
    from repro_torch.kernels.common import GENERATED_BUILDS
    return {k: round(v, 2) for k, v in GENERATED_BUILDS.items()
            if k not in since}


def rif_gather_path(dev, timer, launches, card):
    """decoupled_gather(method="rif") of 256 and 2^16 rows of qwen3-4b's
    embedding shape; the kernel held against its plain version at both."""
    from repro_torch.core import decouple as dec
    from repro_torch.kernels.common import ring_rif
    from repro_torch.kernels.dae_gather import kernel as gk
    from repro_torch.kernels.ring import MAX_RIF
    gen = torch.Generator(device=dev).manual_seed(71)
    n, d = 151_936, 2560
    table = torch.randn((n, d), generator=gen, device=dev)
    small = torch.randint(0, n, (SLOTS * CHUNK,), generator=gen, device=dev,
                          dtype=torch.int32)
    idx = torch.randint(0, n, (1 << 16,), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[:2] = torch.tensor([0, n - 1], dtype=torch.int32)
    launches.reset()
    got_small = dec.decoupled_gather(table, small, method="rif")
    got = dec.decoupled_gather(table, idx, method="rif")
    torch.cuda.synchronize()
    counts = launches.read("rif_gather", ("gather_rif",))
    for g, i in ((got_small, small), (got, idx)):
        if not torch.equal(g, torch.index_select(table, 0, i)):
            raise AssertionError("decoupled_gather(method='rif') differs "
                                 "from index_select")
    chunk = 64
    rif = min(ring_rif(None, chunk * d * 4), MAX_RIF, chunk)
    m = idx.shape[0]
    row = exact_row(
        "gather_rif", "src/repro_torch/csrc/ring_gather.cu",
        "src/repro/kernels/dae_gather/kernel.py:103",
        gk.gather_rif(table, idx, chunk=chunk, rif=rif),
        gk.gather_rif_plain(table, idx), timer,
        lambda: gk.gather_rif(table, idx, chunk=chunk, rif=rif),
        lambda: gk.gather_rif_plain(table, idx),
        distinct_rows(idx) * d * 4 + m * d * 4 + m * 4,
        lambda: torch.index_select(table, 0, idx), " (index_select)")
    small_ms = timer(lambda: gk.gather_rif(table, small, chunk=chunk,
                                           rif=rif))
    log(f"rif_gather: {m} rows of ({n}, {d}) float32, chunk {chunk}, rif "
        f"{rif} (plan_rif over one chunk); {small.shape[0]} rows "
        f"{small_ms:.4f} ms; launches {json.dumps(counts)} ({card})")
    return row


def compile_path(name, scale, dev, launches, card):
    """compile_target then CompiledKernel() on the card; the output must
    equal the simulator oracle bit for bit.  Returns the compiled kernel
    and its target."""
    from repro_torch.compile.targets import assert_parity, compile_target
    kernel = COMPILED_KERNEL[name]
    from repro_torch.kernels.common import GENERATED_BUILDS
    before = dict(GENERATED_BUILDS)
    t0 = time.perf_counter()
    ck, target = compile_target(name, scale, device=dev)
    total = time.perf_counter() - t0
    built = chase_builds(before)
    launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ck()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launches.read(f"compile_{name}_{scale}", (kernel,))
    t0 = time.perf_counter()
    oracle = target.simulate_oracle()
    oracle_s = time.perf_counter() - t0
    assert_parity(out, oracle)
    passes = {k: round(v, 3) for k, v in ck.pass_seconds.items()}
    passes["build_target"] = round(total - sum(ck.pass_seconds.values()), 3)
    shape = {p: tuple(a.shape) for p, a in out.items()}
    log(f"compile {name} [{scale}]: shape {ck.shape}, outputs {shape}, "
        f"bit-identical to the simulator oracle; host s {json.dumps(passes)}"
        f", CompiledKernel() {run_s:.3f} s, oracle {oracle_s:.2f} s; "
        f"launches {kernel} {counts[kernel]}; chase kernels built in "
        f"codegen (s): {json.dumps(built)} ({card})")
    for line in ck.describe().splitlines()[1:]:
        if line.startswith(("  plan", "  channel", "  stores")):
            log(f"  {line.strip()}")
    return ck, target


def check_compile_rejects(target, dev):
    from repro_torch.compile import CompileError, compile_program
    try:
        compile_program(target.prog, target.memories, device=dev)
    except CompileError as e:
        if "Supply a ChaseSpec" not in str(e):
            raise AssertionError(f"binsearch without a ChaseSpec: {e}")
        log("binsearch without a ChaseSpec raises CompileError with the "
            "ChaseSpec hint")
        return
    raise AssertionError("binsearch compiled without a ChaseSpec")


def ring_gather_row(dev, timer, port, addrs):
    from repro_torch.kernels.compiled import kernel as rk
    n, w = port.shape
    m = addrs.shape[0]
    kw = dict(chunk=64, rif=16)
    return exact_row(
        "ring_gather", "src/repro_torch/csrc/ring_gather.cu",
        "src/repro/kernels/compiled/kernel.py:64",
        rk.ring_gather(port, addrs, **kw), rk.ring_gather_plain(port, addrs),
        timer, lambda: rk.ring_gather(port, addrs, **kw),
        lambda: rk.ring_gather_plain(port, addrs),
        distinct_rows(addrs) * w * 4 + m * w * 4 + m * 4,
        lambda: torch.index_select(port, 0, addrs), " (index_select)")


def ring_deref_row(dev, timer, card, port):
    """a (2^27, 1) int32 whose values are the data port's rows."""
    from repro_torch.kernels.compiled import kernel as rk
    gen = torch.Generator(device=dev).manual_seed(73)
    na = 1 << 27
    a = torch.randint(0, port.shape[0], (na, 1), generator=gen, device=dev,
                      dtype=torch.int32)
    addrs = torch.randint(0, na, (RING_ITEMS,), generator=gen, device=dev,
                          dtype=torch.int32)
    kw = dict(chunk=64, rif_a=16, rif_b=16, offset=0)
    got = rk.ring_deref(a, port, addrs, **kw)
    want = rk.ring_deref_plain(a, port, addrs, offset=0)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("ring_deref: kernel differs from plain")
    va = a[addrs.long(), 0]
    m, w = RING_ITEMS, port.shape[1]
    nbytes = (m * 4 + distinct_rows(addrs) * 4 + distinct_rows(va) * w * 4
              + m * 4 + m * w * 4)
    b_ms, b_by = bound(nbytes, 0)

    def library():
        return torch.index_select(port, 0, torch.index_select(a, 0, addrs)
                                  .view(-1))
    if not torch.equal(library(), want[1]):
        raise AssertionError("ring_deref differs from two index_selects")
    # the index hop alone: a random gather of M words of the index port
    hop_ms = timer(lambda: torch.index_select(a, 0, addrs))
    log(f"ring_deref: {m} items via ({na}, 1) int32 into {tuple(port.shape)} "
        f"float32, {json.dumps(kw)}; the index hop alone (index_select of "
        f"{m} words) {hop_ms:.4f} ms ({card})")
    return {"name": "ring_deref", "route": "cuda",
            "source": "src/repro_torch/csrc/ring_deref.cu",
            "replaces": "src/repro/kernels/compiled/kernel.py:122",
            "max_abs_err": 0.0, "limit": "0, exact",
            "ms": timer(lambda: rk.ring_deref(a, port, addrs, **kw)),
            "plain_ms": timer(lambda: rk.ring_deref_plain(a, port, addrs),
                              iters=10),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": timer(library),
            "library": " (two index_selects)"}


def ring_chase_rows(dev, timer, card, rif):
    """The binsearch_for spec (27 lock-step levels) over phase 6's table
    and keys, held against torch.searchsorted as well as its plain
    version; the early-exit binsearch spec on the same keys.  ``rif`` is
    the depth infer_plans gave the compiled binsearch_for."""
    from repro_torch.bench import binsearch_data
    from repro_torch.compile.chase import trace_chase
    from repro_torch.compile.targets import _binsearch_chase
    from repro_torch.kernels.common import GENERATED_BUILDS
    from repro_torch.kernels.compiled import kernel as rk
    table, keys = binsearch_data(dev)
    n, m = table.shape[0], keys.shape[0]
    port = table.view(n, 1)
    rows = []
    for early in (False, True):
        spec = _binsearch_chase({"arr": None, "keys": keys.cpu().numpy(),
                                 "n": n}, early)
        s = spec.state_width
        prog = trace_chase(spec.addr_fn, spec.step_fn, spec.out_fn, s, 1)
        state0 = torch.from_numpy(spec.state0.reshape(-1)).to(dev)
        kw = dict(rif=rif, max_steps=spec.max_steps, s_width=s)
        before = dict(GENERATED_BUILDS)
        rk.chase_library(prog)
        built = chase_builds(before)
        got = rk.ring_chase(port, state0, prog, **kw)
        want = rk.ring_chase_plain(port, state0, prog,
                                   max_steps=spec.max_steps, s_width=s)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"ring_chase (early={early}): kernel "
                                     "differs from plain at "
                                     f"{int((g != w).sum())} items")
        name = "binsearch" if early else "binsearch_for"
        if not torch.equal(got[0], torch.arange(m, dtype=torch.int32,
                                                device=dev)):
            raise AssertionError(f"ring_chase {name}: store addresses")
        if not early:
            lib = torch.searchsorted(table, keys, right=True)
            if not torch.equal(got[1], lib.to(torch.int32)):
                raise AssertionError("ring_chase binsearch_for differs from "
                                     "torch.searchsorted")
        # the bound: the distinct rows each level reads, the state, outputs
        st = tuple(state0.view(m, s)[:, j] for j in range(s))
        touched = 0
        for _ in range(spec.max_steps):
            a = rk._items(spec.addr_fn(st), m, port).long().clamp(0, n - 1)
            touched += distinct_rows(a)
            st = tuple(rk._items(v, m, port)
                       for v in spec.step_fn(st, (port[a, 0],)))
        n_addr, n_step, n_out = (int(x) for x in prog.words[3:6])
        ops = m * (spec.max_steps * (n_addr + n_step) + n_out)
        t_bytes = (touched * 4 + m * s * 4 + 2 * m * 4) / HBM_BYTES_PER_S
        t_ops = ops / INT32_OPS
        ms = timer(lambda: rk.ring_chase(port, state0, prog, **kw))
        plain_ms = timer(lambda: rk.ring_chase_plain(
            port, state0, prog, max_steps=spec.max_steps, s_width=s),
            iters=5)
        log(f"ring_chase {name}: {m} keys x {spec.max_steps} levels in "
            f"{n} int32 at rif {rif}, {prog.n_instr} instructions ({n_addr} address, "
            f"{n_step} step, {n_out} output) in {prog.n_regs} registers, "
            f"{touched} distinct (level, row) loads; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms; kernel built (s) {json.dumps(built)} "
            f"({card})")
        if early:
            continue
        rows.append({
            "name": "ring_chase", "case": f"[binsearch_for, rif {rif}]",
            "route": "cuda", "source": "src/repro_torch/csrc/ring_chase.cuh",
            "replaces": "src/repro/kernels/compiled/kernel.py:212",
            "max_abs_err": 0.0, "limit": "0, exact", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": timer(lambda: torch.searchsorted(table, keys,
                                                           right=True)),
            "library": " (torch.searchsorted, right)"})
    return rows


def run_compiler(dev, launches, card):
    from repro_torch.bench import ColdTimer
    from repro_torch.compile.targets import COMPILE_TARGETS
    timer = ColdTimer(dev)
    rows = [rif_gather_path(dev, timer, launches, card)]
    torch.cuda.empty_cache()
    for name in sorted(COMPILE_TARGETS):
        _, target = compile_path(name, "small", dev, launches, card)
        if name == "binsearch":
            check_compile_rejects(target, dev)
    for name in ("gather", "binsearch", "binsearch_for"):
        ck, _ = compile_path(name, "paper", dev, launches, card)
    (plan,) = ck.plans.values()           # binsearch_for's one channel

    gen = torch.Generator(device=dev).manual_seed(72)
    port = torch.randn(RING_PORT, generator=gen, device=dev)
    addrs = torch.randint(0, RING_PORT[0], (RING_ITEMS,), generator=gen,
                          device=dev, dtype=torch.int32)
    rows.append(ring_gather_row(dev, timer, port, addrs))
    rows.append(ring_deref_row(dev, timer, card, port))
    del port, addrs
    torch.cuda.empty_cache()
    rows += ring_chase_rows(dev, timer, card, plan.rif)
    for r in rows:
        log(row_line(r, card))
    return rows


# ---------------------------------------------------------------------------
# phase 8: the tuner
# ---------------------------------------------------------------------------

# deepseek's decode step through the MoE dispatch: 8 tokens x top-6 pairs
# rounded to whole blocks, plus a block for each of the 64 experts
DEEPSEEK_DECODE_T = (-(-SLOTS * DEEPSEEK_MOE[1] // BT) * BT
                     + DEEPSEEK_MOE[0] * BT)
# each op at shapes phases 3, 6 and 7 time: (op, dims)
TUNE_SHAPES = (
    ("dae_gather", (151_936, 2560, SLOTS * CHUNK)),   # qwen3, a chunk
    ("dae_gather", (151_936, 2560, 1 << 16)),         # rif_gather's rows
    ("dae_merge", (1 << 23, 1 << 23)),
    ("flash_attention", (PREFILL_S, PREFILL_S, 64)),  # granite's prefill
    ("flash_decode", (S_MAX, 128)),                   # qwen3, 8 slots
    ("flash_decode_paged", (PAGE, 128)),
    ("grouped_matmul", (DEEPSEEK_DECODE_T, DEEPSEEK_MOE[2],
                        DEEPSEEK_MOE[3])),
    ("batched_searchsorted", (1 << 27, 1 << 22)),
    ("hash_lookup", (1 << 24, 1 << 20)),
    # 8 entries a row as phase 6's, 2^16 of them: nearly every entry its
    # own block, so the largest block shape (32 x 256) holds 2 GiB
    ("dae_spmv", (8192, 1 << 24, 1 << 16)),
)
TUNE_COMPILED = tuple((name, "small") for name in (
    "binsearch", "binsearch_for", "frontier_gather", "gather",
    "spmv_gather")) + (("binsearch", "paper"),)
TUNE_WORKLOADS = ("hashtable", "binsearch", "spmv", "mergesort_opt")
TUNE_EVALS, TUNE_REPS = 16, 2


def _same_as_plain(op, got, want, measure):
    """The tuned dispatch's output against the plain version's: exact,
    SpMV within 1e-5 of the largest row sum of |val * vec|, attention
    and gmm within the bf16 limit.  Returns the max |err|."""
    if op in ("flash_attention", "flash_decode", "flash_decode_paged",
              "grouped_matmul"):
        return assert_close_bf16(f"tuned {op}", got, want)
    if op == "dae_spmv":
        got = got[:want.shape[0]]
        err = float((got - want).abs().max())
        limit = 1e-5 * measure.row_bound()
        if not err <= limit:
            raise AssertionError(f"tuned dae_spmv: max |err| {err} > {limit}")
        return err
    if not torch.equal(got, want):
        raise AssertionError(f"tuned {op}: output differs from the plain "
                             "version")
    return 0.0


def _ms(seconds):
    return f"{1e3 * seconds:.4f}"


def tune_kernel_op(op, dims, dev, launches, card):
    """tune_kernel at ``dims``, a second call (a cache hit), then one
    dispatch with every knob None: the kernel must receive the winner's
    knobs and launch, and its output equal the plain version's."""
    from repro_torch.tune import kernel_runner, kernel_space, tune_kernel
    from repro_torch.tune.seam import seam_knobs, spied
    t0 = time.perf_counter()
    res = tune_kernel(op, dims, device=dev, max_evals=TUNE_EVALS,
                      reps=TUNE_REPS)
    secs = time.perf_counter() - t0
    again = tune_kernel(op, dims, device=dev)
    if again.evals != 0 or again.best != res.best:
        raise AssertionError(f"tune {op}: the second call searched again")
    measure, _, _ = kernel_runner(op, dims, device=dev, reps=TUNE_REPS)
    wrapper, want = seam_knobs(op, res.best, dims)
    kernel = "dae_gather" if wrapper == "gather_rows" else wrapper
    launches.reset()
    got, seen = spied(op, lambda: measure.run(None))
    torch.cuda.synchronize()
    counts = launches.read(f"tuned_{op}_{'x'.join(map(str, dims))}",
                           (kernel,))
    if seen.get(wrapper) != want:
        raise AssertionError(f"tune {op}: the kernel received {seen}, the "
                             f"winner {res.best} gives {wrapper} {want}")
    err = _same_as_plain(op, got, measure.ref(), measure)
    size = kernel_space(op, *dims).size
    log(f"tune {op} {dims}: seed {json.dumps(res.seed)} {_ms(res.seed_score)}"
        f" ms -> winner {json.dumps(res.best)} {_ms(res.best_score)} ms "
        f"({res.evals} of {size} points, {secs:.1f} s); again: evals "
        f"{again.evals}; knobs None: {wrapper} received {json.dumps(want)}, "
        f"launched {counts[kernel]}, max |err| against plain {err} ({card})")
    del measure, got
    torch.cuda.empty_cache()
    return {"op": op, "dims": list(dims), "seed": res.seed,
            "seed_ms": 1e3 * res.seed_score, "best": res.best,
            "best_ms": 1e3 * res.best_score, "evals": res.evals,
            "points": size, "seconds": secs}


def tune_compiled_target(name, scale, dev, launches, card):
    """tune_compiled, a second call, then compile_target with no knobs:
    every plan must come from the cache at the winner's knobs (as
    infer_plans clamps them), the ring kernel launch, and the output
    equal the simulator oracle."""
    from repro_torch.compile import elaborate, infer_plans
    from repro_torch.compile.targets import assert_parity, compile_target
    from repro_torch.tune import tune_compiled
    kernel = COMPILED_KERNEL[name]
    t0 = time.perf_counter()
    res = tune_compiled(name, scale=scale, device=dev, max_evals=TUNE_EVALS,
                        reps=TUNE_REPS)
    secs = time.perf_counter() - t0
    again = tune_compiled(name, scale=scale, device=dev)
    if again.evals != 0 or again.best != res.best:
        raise AssertionError(f"tune {name}: the second call searched again")
    ck, target = compile_target(name, scale, device=dev)
    want = infer_plans(elaborate(target.prog, target.memories),
                       device=dev, **res.best)
    got = {c: (p.chunk, p.rif, p.source) for c, p in ck.plans.items()}
    if got != {c: (p.chunk, p.rif, "cache") for c, p in want.items()}:
        raise AssertionError(f"tune {name}: plans {got}, the winner "
                             f"{res.best} gives {want}")
    launches.reset()
    out = ck()
    torch.cuda.synchronize()
    counts = launches.read(f"tuned_compile_{name}_{scale}", (kernel,))
    assert_parity(out, target.simulate_oracle())
    log(f"tune compiled:{name} [{scale}]: seed {json.dumps(res.seed)} "
        f"{_ms(res.seed_score)} ms -> winner {json.dumps(res.best)} "
        f"{_ms(res.best_score)} ms ({res.evals} evals, {secs:.1f} s); again: "
        f"evals {again.evals}; compile_target with no knobs: plans "
        f"{json.dumps(got)}, {kernel} launched {counts[kernel]}, "
        f"bit-identical to the simulator oracle ({card})")
    return {"target": name, "scale": scale, "seed": res.seed,
            "seed_ms": 1e3 * res.seed_score, "best": res.best,
            "best_ms": 1e3 * res.best_score, "evals": res.evals,
            "seconds": secs}


def tune_workload_cell(bench):
    """tune_workload at "small", a second call, then the winner's knobs
    run through run_workload: its cycles, and a correct result."""
    from repro_torch.core.workloads import run_workload
    from repro_torch.tune import tune_workload
    res = tune_workload(bench, "rhls_dec", scale="small")
    again = tune_workload(bench, "rhls_dec", scale="small")
    if again.evals != 0 or again.best != res.best:
        raise AssertionError(f"tune {bench}: the second call searched again")
    rep = run_workload(bench, "rhls_dec", scale="small", latency=100,
                       rif=res.best["rif"], cap_slack=res.best["cap_slack"])
    if not rep.correct or rep.cycles != res.best_score:
        raise AssertionError(f"tune {bench}: the winner ran {rep.cycles} "
                             f"cycles (correct {rep.correct})")
    log(f"tune workload:{bench} [small, latency 100]: seed "
        f"{json.dumps(res.seed)} {res.seed_score:.0f} cycles -> winner "
        f"{json.dumps(res.best)} {res.best_score:.0f} cycles ({res.evals} "
        f"evals); again: evals {again.evals}; run_workload at the winner: "
        f"{rep.cycles} cycles, correct")
    return {"workload": bench, "seed": res.seed, "best": res.best,
            "seed_cycles": res.seed_score, "best_cycles": res.best_score,
            "evals": res.evals}


def lookup_cost(dev):
    """Host microseconds of one dispatcher lookup (the serve path's
    ``tuned_knobs``), on a miss and on a hit."""
    from repro_torch.kernels.common import backend_tag, tuned_knobs
    from repro_torch.tune import CacheEntry, default_cache, make_key
    n = 20_000
    dev = torch.device("cuda", torch.cuda.current_device())

    def per_call(dims):
        t0 = time.perf_counter()
        for _ in range(n):
            tuned_knobs("flash_decode", dims, torch.bfloat16, dev,
                        bk=(None, 16), rif=(None, None))
        return 1e6 * (time.perf_counter() - t0) / n
    miss = per_call((3, 5))
    default_cache().put(make_key("flash_decode", (5, 3), torch.bfloat16,
                                 backend_tag(dev), "wallclock"),
                        CacheEntry(config={"bk": 16}, score=1.0))
    return miss, per_call((5, 3))


def run_tuning(dev, launches, card):
    """Phase 8: every kernel op, compile target and workload tuned."""
    from repro_torch.tune import cache_path
    t0 = time.perf_counter()
    ops = [tune_kernel_op(op, dims, dev, launches, card)
           for op, dims in TUNE_SHAPES]
    compiled = [tune_compiled_target(name, scale, dev, launches, card)
                for name, scale in TUNE_COMPILED]
    workloads = [tune_workload_cell(b) for b in TUNE_WORKLOADS]
    miss_us, hit_us = lookup_cost(dev)
    log(f"tune cache lookup: {miss_us:.2f} us a miss, {hit_us:.2f} us a hit "
        f"(host); cache {cache_path()}; phase 8 took "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    return {"ops": ops, "compiled": compiled, "workloads": workloads,
            "lookup_us": {"miss": miss_us, "hit": hit_us}}


# ---------------------------------------------------------------------------
# phase 9: the port's serve axis, granite-34b at full width
# ---------------------------------------------------------------------------


def _recording(fn, out):
    """``fn`` (a bundle step returning (logits, cache)) that also appends
    each call's logits to ``out``."""
    def step(*args):
        logits, cache = fn(*args)
        out.append(logits)
        return logits, cache
    return step


def _ttft_ms(stats, reqs):
    from repro_torch.bench import percentiles
    pct = percentiles([stats.ttft[r.rid] for r in reqs], (50.0, 95.0))
    return round(1e3 * pct["p50"], 3), round(1e3 * pct["p95"], 3)


def _peak_gib() -> float:
    return round(torch.cuda.max_memory_allocated() / 2**30, 3)


def serve_cells(cfg, bundle, params, dev, launches):
    """The four cells of the ``serve`` axis over one built model: the
    paged and contiguous loops on ``main_requests`` (the paged cell also
    serves the 700-token prompt again), the coupled ``LegacyServeLoop``
    against ``ServeLoop`` on the serve bench's "mixed" mix, and both at
    one slot.  Integer derived values are structural (tokens, steps,
    pages, launches, equal streams), floats are timings."""
    from repro_torch.bench import Cell, CellResult, coords
    from repro_torch.kernels.common import backend_tag
    from repro_torch.runtime.serve_loop import (LegacyServeLoop,
                                                PagedServeLoop, Request,
                                                ServeLoop)
    arch, layers = cfg.arch, cfg.n_layers
    shared = {}

    def where(name, slots):
        return coords(f"{arch}-{name}", "serve", engine="kernel",
                      backend=backend_tag(dev), tenants=slots, tuned=False)

    def launched(path, want):
        return launches.read(path, [k for k, v in want.items() if v], want)

    def paged(ctx) -> CellResult:
        prompts, reqs = main_requests(cfg.vocab)
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        loop = PagedServeLoop(cfg, bundle, params, batch_slots=SLOTS,
                              s_max=S_MAX, chunk=CHUNK, page=PAGE)
        res, wall = serve(loop, reqs)
        st = loop.stats
        pre, dec = st.prefill_steps, st.decode_steps
        ttft = _ttft_ms(st, reqs)
        _, wall_again = serve(loop, [Request(rid=100, prompt=prompts[1],
                                             max_new=MAX_NEW)])
        if st.prefix_hits < 1:
            raise AssertionError("the repeated prompt reused no prefix")
        steps = st.prefill_steps + st.decode_steps
        counts = launched(f"{arch}_paged_serve", {
            "flash_decode_paged": layers * st.decode_steps,
            "dae_gather": steps, "flash_decode": 0})
        shared["paged"] = res
        tokens = sum(map(len, res.values()))
        return CellResult(us_warm=wall * 1e6, derived={
            "requests": len(reqs), "tokens": tokens,
            "prefill_steps": pre, "decode_steps": dec,
            "again_prefill_steps": st.prefill_steps - pre,
            "again_decode_steps": st.decode_steps - dec,
            "page_allocs": st.page_allocs, "prefix_hits": st.prefix_hits,
            "prefix_tokens_reused": st.prefix_tokens_reused,
            "preemptions": st.preemptions,
            "flash_decode_paged_launches": counts["flash_decode_paged"],
            "dae_gather_launches": counts["dae_gather"],
            "again_wall_s": round(wall_again, 3),
            "tok_s": round(tokens / wall, 3), "ttft_p50_ms": ttft[0],
            "ttft_p95_ms": ttft[1], "peak_gib": _peak_gib()})

    def contig(ctx) -> CellResult:
        _, reqs = main_requests(cfg.vocab)
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        loop = ServeLoop(cfg, bundle, params, batch_slots=SLOTS, s_max=S_MAX,
                         chunk=CHUNK)
        res, wall = serve(loop, reqs)
        st = loop.stats
        counts = launched(f"{arch}_contiguous_serve", {
            "flash_decode": layers * st.decode_steps,
            "dae_gather": st.prefill_steps + st.decode_steps,
            "flash_decode_paged": 0})
        same = sum(res[r] == shared["paged"][r] for r in res)
        if same != len(res):
            raise AssertionError(f"{arch}: {same}/{len(res)} streams equal "
                                 "across the paged and contiguous loops")
        tokens = sum(map(len, res.values()))
        ttft = _ttft_ms(st, reqs)
        return CellResult(us_warm=wall * 1e6, derived={
            "requests": len(reqs), "tokens": tokens,
            "prefill_steps": st.prefill_steps,
            "decode_steps": st.decode_steps,
            "flash_decode_launches": counts["flash_decode"],
            "dae_gather_launches": counts["dae_gather"],
            "streams_equal_to_paged": same,
            "tok_s": round(tokens / wall, 3), "ttft_p50_ms": ttft[0],
            "ttft_p95_ms": ttft[1], "peak_gib": _peak_gib()})

    def mixed_requests():
        rng = np.random.default_rng(0)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                                   size=MIXED[i % 2]),
                        max_new=LEGACY_NEW) for i in range(LEGACY_REQUESTS)]

    def legacy(ctx) -> CellResult:
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        new = ServeLoop(cfg, bundle, params, batch_slots=SLOTS,
                        s_max=LEGACY_S_MAX, chunk=LEGACY_CHUNK)
        reqs = mixed_requests()
        res, wall = serve(new, reqs)
        st = new.stats
        launched(f"{arch}_mixed_serve", {
            "flash_decode": layers * st.decode_steps,
            "dae_gather": st.prefill_steps + st.decode_steps})
        ttft = _ttft_ms(st, reqs)
        launches.reset()
        old = LegacyServeLoop(cfg, bundle, params, batch_slots=SLOTS,
                              s_max=LEGACY_S_MAX)
        res_l, wall_l = serve(old, mixed_requests())
        counts = launched(f"{arch}_mixed_legacy_serve", {
            "flash_decode": layers * old.steps, "dae_gather": old.steps,
            "flash_decode_paged": 0})
        toks, toks_l = (sum(map(len, r.values())) for r in (res, res_l))
        return CellResult(us_warm=wall * 1e6, derived={
            "requests": len(reqs), "tokens": toks,
            "prefill_steps": st.prefill_steps,
            "decode_steps": st.decode_steps, "legacy_tokens": toks_l,
            "legacy_steps": old.steps,
            "legacy_flash_decode_launches": counts["flash_decode"],
            "tok_s": round(toks / wall, 3),
            "legacy_tok_s": round(toks_l / wall_l, 3),
            "speedup": round((toks / wall) / (toks_l / wall_l), 3),
            "legacy_wall_s": round(wall_l, 3),
            "ttft_p50_ms": ttft[0], "ttft_p95_ms": ttft[1],
            "peak_gib": _peak_gib()})

    def parity(ctx) -> CellResult:
        rng = np.random.default_rng(7)
        prompt = rng.integers(0, cfg.vocab, size=PARITY_PROMPT)
        rec_new, rec_old = [], []
        new = ServeLoop(cfg, dataclasses.replace(
            bundle, prefill=_recording(bundle.prefill, rec_new)), params,
            batch_slots=1, s_max=LEGACY_S_MAX, chunk=LEGACY_CHUNK)
        out_new, wall = serve(new, [Request(rid=0, prompt=prompt,
                                            max_new=PARITY_NEW)])
        launches.reset()
        old = LegacyServeLoop(cfg, dataclasses.replace(
            bundle, decode_step=_recording(bundle.decode_step, rec_old)),
            params, batch_slots=1, s_max=LEGACY_S_MAX)
        out_old, wall_l = serve(old, [Request(rid=0, prompt=prompt,
                                              max_new=PARITY_NEW)])
        launched(f"{arch}_parity_legacy_serve", {
            "flash_decode": layers * old.steps, "dae_gather": old.steps})
        # the logits that chose each loop's first token: the last prompt
        # chunk's, and the last prompt token's full-batch step's
        a = rec_new[-(-PARITY_PROMPT // LEGACY_CHUNK) - 1][0]
        b = rec_old[PARITY_PROMPT - 1][0]
        err = float((b - a).abs().max())
        limit = LOGIT_RTOL * float(a.abs().max())
        if not (bool(torch.isfinite(b).all()) and err <= limit):
            raise AssertionError(f"{arch} one slot: the coupled loop's first "
                                 f"logits differ by {err} > {limit}")
        same = sum(x == y for x, y in zip(out_new[0], out_old[0]))
        return CellResult(us_warm=wall * 1e6, derived={
            "tokens": len(out_new[0]), "legacy_tokens": len(out_old[0]),
            "legacy_steps": old.steps,
            "first_token_equal": int(out_new[0][0] == out_old[0][0]),
            "tokens_equal": same, "first_logits_err": round(err, 6),
            "first_logits_limit": round(limit, 6),
            "legacy_wall_s": round(wall_l, 3)})

    return [
        Cell("serve", f"serve/{arch}/paged/s{SLOTS}", where("paged", SLOTS),
             paged, group="serve-granite-34b"),
        Cell("serve", f"serve/{arch}/contig/s{SLOTS}", where("contig", SLOTS),
             contig, group="serve-granite-34b"),
        Cell("serve", f"serve/legacy/{arch}/mixed/s{SLOTS}",
             where("legacy-mixed", SLOTS), legacy,
             group="serve-granite-34b"),
        Cell("serve", f"serve/parity/{arch}/legacy-vs-decoupled",
             where("parity", 1), parity, group="serve-granite-34b")]


def run_serve_axis(dev, launches, card):
    """granite-34b at full width (88 layers, bf16, ~34 B parameters):
    its logits through the kernels against the plain path, its
    ``make_prefill_step``, then the four ``serve`` cells through
    ``repro_torch.bench.run_axis`` twice, each report validated, the
    second diffed against the first (walls swing between runs, so wall
    findings are printed, any other finding fails)."""
    from repro_torch.bench import (BenchContext, diff_reports, load_report,
                                   run_axis)
    from repro_torch.launch.steps import make_prefill_step
    torch.cuda.reset_peak_memory_stats()
    cfg, bundle, params = build_full(GRANITE34, dev)
    log(f"{GRANITE34} weights {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB ({card})")
    errs = check_logits(cfg, params, dev, (True, False), with_step=True)
    log(f"{GRANITE34} logits kernel vs plain (max |err|, limit): "
        f"{json.dumps(errs)}")

    tok = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S)), dtype=torch.int32, device=dev)
    step = make_prefill_step(cfg)
    step(params, {"tokens": tok[:, :64]})                 # warm the allocator
    torch.cuda.synchronize()
    launches.reset()
    t0 = time.perf_counter()
    logits = step(params, {"tokens": tok})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches.read(f"{GRANITE34}_prefill_step", ("flash",
                                                         "dae_gather"),
                           {"flash": cfg.n_layers, "dae_gather": 1})
    if tuple(logits.shape) != (PREFILL_B, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill step logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    del logits
    log(f"{GRANITE34} make_prefill_step: {PREFILL_B} x {PREFILL_S} tokens in "
        f"{wall:.3f} s; launches {json.dumps(counts)}; peak memory so far "
        f"{_peak_gib():.2f} GiB ({card})")

    cells = serve_cells(cfg, bundle, params, dev, launches)
    reports = []
    for run, out in enumerate((OUT_DIR, OUT_DIR / "serve_second_run")):
        out.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        run_axis("serve", cells, BenchContext(smoke=False, seed=0),
                 out_dir=out, csv_print=log)
        path = out / "BENCH_serve.json"
        reports.append(load_report(path))       # validated on the way in
        log(f"serve axis run {run + 1}: {len(cells)} cells in "
            f"{time.perf_counter() - t0:.1f} s, schema-valid report at "
            f"{path.relative_to(OUT_DIR.parents[1])} ({card})")
    findings = diff_reports(reports[0], reports[1])
    for f in findings:
        log("serve axis diff: " + f.render())
    bad = [f for f in findings if f.kind not in (
        "wall-clock", "wall-clock-improved", "new-cell")]
    if bad:
        raise AssertionError("serve axis: findings between two runs: "
                             + "; ".join(f.render() for f in bad))
    log(f"serve axis diff: {len(findings)} findings, none but walls")
    log(f"{GRANITE34} launches by path: " + json.dumps(
        {k: v for k, v in launches.paths.items()
         if k.startswith(GRANITE34)}))
    log(f"{GRANITE34} peak memory {_peak_gib():.2f} GiB ({card})")
    return reports[0]


# ---------------------------------------------------------------------------
# phase 10: training granite-moe-3b-a800m
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 4, 1024, 8, 3e-4
# the card's train step against the CPU's: full width, depth 2, float32
CHECK_DEPTH, CHECK_TRAIN_B, CHECK_TRAIN_S = 2, 1, 128
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-4           # of each leaf's largest |g|
# fit: 6 steps, a checkpoint every 2, a failure injected at step 3, then
# a second call to 8
FIT_STEPS, FIT_EVERY, FIT_FAIL_AT, FIT_MORE = 6, 2, 3, 8
FIT_DIR = Path(__file__).resolve().parent / "build" / "train_ckpt"


def active_matmul_params(cfg) -> int:
    """Matrix parameters one token passes through: attention, the
    router, top-k experts (and shared ones), dense MLPs, the LM head."""
    d, hd = cfg.d_model, cfg.hd
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    mlp = 3 * d * cfg.d_ff
    f = cfg.moe_d_ff or cfg.d_ff
    moe = d * cfg.n_experts + 3 * d * f * (cfg.top_k + cfg.n_shared_experts)
    total = 0
    for spec in cfg.layer_specs():
        total += spec.count * (attn + (moe if spec.kind == "moe" else mlp))
    return total + d * cfg.vocab


class _Timed:
    """An optimizer that records the device time of its update between
    two CUDA events (on the card) and, when asked, a host copy of the
    gradients it was given (in JAX's layout): the train step's seam
    between backward and the update."""

    def __init__(self, opt, keep_grads=False):
        self.opt, self.keep_grads, self.grads = opt, keep_grads, None
        self.events = None

    def update(self, grads, state, params):
        from repro_torch.models.convert import params_to_numpy
        if self.keep_grads:
            self.grads = params_to_numpy(grads)
        if not next(iter(grads.values())).is_cuda:
            return self.opt.update(grads, state, params)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = self.opt.update(grads, state, params)
        e1.record()
        self.events = (e0, e1)
        return out


def numpy_weights(cfg, seed: int):
    """JAX's parameter tree of ``cfg`` drawn with numpy: each matrix
    N(0, 1/d_in) in float32, the norm gains 1."""
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.models.transformer import LM
    rng = np.random.default_rng(seed)
    model = LM(cfg, torch.device("cpu"), dtype=torch.float32)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.fill_(1.0)
            else:
                p.copy_(torch.from_numpy(rng.standard_normal(
                    tuple(p.shape), dtype=np.float32))
                    * (1.0 / math.sqrt(p.shape[-2])))
    return params_to_numpy(model)


def train_full(dev, launches, card):
    """granite-moe-3b-a800m at full width and depth: float32 parameters
    and AdamW state, bf16 compute, ``kernel_mode="ref"``; TRAIN_STEPS
    steps of ``make_train_step`` on one repeated batch."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW
    cfg = get_config(GRANITE, kernel_mode="ref")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                   dtype=cfg.pdtype)
    opt = _Timed(AdamW(lr=TRAIN_LR))
    state = opt.opt.init(params)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    gib = torch.cuda.memory_allocated() / 2**30
    log(f"{GRANITE} trainer: {n} parameters ({cfg.n_layers} layers), float32 "
        f"parameters and AdamW state {gib:.2f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    step = make_train_step(cfg, opt)
    batch = SyntheticLM(cfg.vocab, TRAIN_S, TRAIN_B).batch_at(0)
    tokens = TRAIN_B * TRAIN_S
    launches.reset()
    rows = []
    for i in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        e0, e1 = opt.events
        rows.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "wall_s": wall,
                     "fwd_bwd_ms": start.elapsed_time(e0),
                     "opt_ms": e0.elapsed_time(e1)})
        log(f"{GRANITE} train step {i + 1}: " + json.dumps(rows[-1]))
    counts = launches.read("granite_train", (), {k: 0 for k in launches.fns})
    bad = [r for r in rows if not (math.isfinite(r["loss"])
                                   and math.isfinite(r["grad_norm"]))]
    if bad or not rows[-1]["loss"] < rows[0]["loss"]:
        raise AssertionError(f"{GRANITE} training: losses "
                             f"{[r['loss'] for r in rows]} not finite or not "
                             "falling")
    warm = rows[1:]
    wall = float(np.median([r["wall_s"] for r in warm]))
    fb = float(np.median([r["fwd_bwd_ms"] for r in warm]))
    om = float(np.median([r["opt_ms"] for r in warm]))
    flops = 6 * active_matmul_params(cfg) * tokens
    summary = {"steps": TRAIN_STEPS, "tokens_per_step": tokens,
               "first_two": [{k: r[k] for k in ("loss", "grad_norm")}
                             for r in rows[:2]],
               "loss_first": rows[0]["loss"], "loss_last": rows[-1]["loss"],
               "step_wall_s_median": wall, "fwd_bwd_ms_median": fb,
               "optimizer_ms_median": om,
               "optimizer_share": om / (fb + om),
               "tokens_per_s": tokens / wall,
               "active_matmul_params": active_matmul_params(cfg),
               "model_tflop_per_step": flops / 1e12,
               "model_tflops": flops / wall / 1e12,
               "model_flops_share_of_989": flops / wall / BF16_FLOPS,
               "peak_gib": _peak_gib(), "launches": counts}
    log(f"{GRANITE} training summary: {json.dumps(summary)} ({card})")
    return summary


def train_check_cpu(dev, card):
    """One ``train_step`` at full width and depth 2 in float32 on the
    card and on the CPU, from the same numpy weights: loss, grad norm and
    every gradient leaf held to the CPU's.  Then the kernel-mode guard on
    CUDA tensors."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import AdamW
    cfg = dataclasses.replace(get_config(GRANITE, kernel_mode="ref"),
                              n_layers=CHECK_DEPTH, dtype="float32")
    t0 = time.perf_counter()
    tree = numpy_weights(cfg, seed=1)
    batch = SyntheticLM(cfg.vocab, CHECK_TRAIN_S, CHECK_TRAIN_B,
                        seed=2).batch_at(0)
    out = {}
    for where in (dev, "cpu"):
        params = params_from_numpy(cfg, tree, device=where, dtype=cfg.pdtype)
        opt = _Timed(AdamW(lr=TRAIN_LR), keep_grads=True)
        step = make_train_step(cfg, opt, device=where)
        _, _, m = step(params, AdamW().init(params), batch)
        out[where] = (float(m["loss"]), float(m["grad_norm"]), opt.grads)
        del params
    (lc, gc, grads_c), (lh, gh, grads_h) = out[dev], out["cpu"]
    errs = {}

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            errs[path] = float(np.abs(a - b).max()) / max(
                float(np.abs(b).max()), 1e-30)
    walk(grads_c, grads_h, "")
    worst = max(errs.values())
    log("gradient leaves, card vs CPU, max |err| over the leaf's max |g|: "
        + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if v > TRAIN_GRAD_TOL}
    if abs(lc - lh) > TRAIN_LOSS_RTOL * abs(lh) or \
            abs(gc - gh) > TRAIN_GNORM_RTOL * abs(gh) or bad:
        raise AssertionError(f"train step card vs CPU: loss {lc} vs {lh}, "
                             f"grad norm {gc} vs {gh}, leaves over "
                             f"{TRAIN_GRAD_TOL}: {bad}")
    log(f"{GRANITE} train step, full width, depth {CHECK_DEPTH}, float32, "
        f"B {CHECK_TRAIN_B} x {CHECK_TRAIN_S}, card vs CPU: loss {lc} vs {lh},"
        f" grad norm {gc} vs {gh}, worst gradient leaf {worst:.3g} of its "
        f"max |g| (limits: loss {TRAIN_LOSS_RTOL} rel, grad norm "
        f"{TRAIN_GNORM_RTOL} rel, leaves {TRAIN_GRAD_TOL}); "
        f"{time.perf_counter() - t0:.1f} s")

    kcfg = dataclasses.replace(cfg, kernel_mode="kernel")
    params = params_from_numpy(kcfg, tree, device=dev, dtype=cfg.pdtype)
    try:
        make_train_step(kcfg, AdamW(), dev)(params, AdamW().init(params),
                                            batch)
    except NotImplementedError as e:
        log(f"kernel-mode train step on the card raised "
            f"NotImplementedError: {e}")
    else:
        raise AssertionError("a kernel-mode train step on the card ran "
                             "instead of raising NotImplementedError")
    return cfg, tree


class _Checked:
    """Mixin for ``CheckpointManager``: keeps an independent host copy of
    every state it is asked to save (taken at the same moment), compares
    each published file with it bit for bit in the writer, and every
    restore with the copy of the step it restored."""

    def setup(self, expected):
        self.expected, self.verified, self.restored = expected, [], []
        return self

    def save(self, step, state, meta=None, block=False):
        from repro_torch.checkpoint.io import flatten
        self.expected[step] = flatten(state)[0]
        super().save(step, state, meta, block)

    def _write(self, step, flat, dtypes, meta):
        from repro_torch.checkpoint.io import read_flat
        super()._write(step, flat, dtypes, meta)
        got = read_flat(self._path(step))[0]
        self._same(step, {k: v.numpy() for k, v in got.items()}, "file")
        self.verified.append(step)

    def restore_latest(self, like):
        from repro_torch.checkpoint.io import flatten
        out = super().restore_latest(like)
        if out is not None:
            self._same(out[0], flatten(out[1])[0], "restore")
            self.restored.append(out[0])
        return out

    def _same(self, step, got, what):
        want = self.expected[step]
        if set(got) != set(want):
            raise AssertionError(f"checkpoint {step} ({what}): keys differ")
        for k, w in want.items():
            if not np.array_equal(got[k], w):
                raise AssertionError(f"checkpoint {step} ({what}): {k} "
                                     "differs from the state it snapshotted")


def train_fit(dev, cfg, tree, card):
    """``fit`` at full width, depth 2: FIT_STEPS steps, a checkpoint every
    FIT_EVERY (async, under build/), a ``StepFailure`` at FIT_FAIL_AT;
    then a second call to FIT_MORE that must resume at FIT_STEPS."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import AdamW
    from repro_torch.runtime import TrainLoopConfig, fit
    from repro_torch.runtime.train_loop import StepFailure

    class Manager(_Checked, CheckpointManager):
        pass

    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    shutil.rmtree(FIT_DIR, ignore_errors=True)
    ds = SyntheticLM(cfg.vocab, TRAIN_S, TRAIN_B, seed=4)
    expected, t0 = {}, time.perf_counter()
    results = []
    for total, hook in ((FIT_STEPS, True), (FIT_MORE, False)):
        params = params_from_numpy(cfg, tree, device=dev, dtype=cfg.pdtype)
        opt = AdamW(lr=TRAIN_LR)
        tripped = []

        def failure_hook(s, armed=hook):
            if armed and s == FIT_FAIL_AT and not tripped:
                tripped.append(s)
                raise StepFailure(f"injected failure at step {s}")

        mgr = Manager(FIT_DIR, keep=3, async_write=True).setup(expected)
        out = fit(make_train_step(cfg, opt, dev), params, opt.init(params),
                  ds.batch_at, TrainLoopConfig(
                      total_steps=total, ckpt_every=FIT_EVERY,
                      ckpt_dir=str(FIT_DIR), async_ckpt=True),
                  failure_hook=failure_hook, manager=mgr)
        mgr.close()
        results.append((out, mgr))
        del params
    (first, m1), (second, m2) = results
    want_first = (FIT_STEPS, 1, [FIT_EVERY])
    got_first = (first["steps"], first["restarts"], m1.restored)
    want_second = (FIT_MORE, FIT_MORE - FIT_STEPS, [FIT_STEPS])
    got_second = (second["steps"], len(second["losses"]), m2.restored)
    if got_first != want_first or got_second != want_second:
        raise AssertionError(f"fit: (steps, restarts, restored) {got_first}, "
                             f"want {want_first}; the second call (steps, "
                             f"steps run, restored) {got_second}, want "
                             f"{want_second}")
    losses = first["losses"] + second["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"fit: losses {losses} not finite")
    writes = [dict(w._asdict(), gib=w.nbytes / 2**30)
              for w in m1.writes + m2.writes]
    log(f"fit: {first['steps']} steps, {first['restarts']} restart (failure "
        f"at step {FIT_FAIL_AT}, restored step {m1.restored[0]}), then "
        f"resumed at {m2.restored[0]} to {second['steps']}; files verified "
        f"bit for bit at steps {m1.verified + m2.verified}, restores at "
        f"{m1.restored + m2.restored}; losses {losses}; "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    log("checkpoint writes: " + json.dumps(writes) + f" ({card})")
    shutil.rmtree(FIT_DIR, ignore_errors=True)
    return {"writes": writes, "losses": losses}


def run_training(dev, launches, card):
    t0 = time.perf_counter()
    summary = train_full(dev, launches, card)
    torch.cuda.empty_cache()
    cfg, tree = train_check_cpu(dev, card)
    torch.cuda.empty_cache()
    fit_out = train_fit(dev, cfg, tree, card)
    torch.cuda.empty_cache()
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s")
    return dict(summary, fit=fit_out)


# ---------------------------------------------------------------------------
# phase 11: the recurrent families, rwkv6-1.6b and hymba-1.5b
# ---------------------------------------------------------------------------


def check_deep_prefill_step(cfg, params, dev, b: int, s: int):
    """``make_prefill_step``'s logits through the kernels against the
    plain path for a model whose depth grows any bf16 attention's
    rounding past the logit limit (Hymba's 32 layers, where SDPA misses
    it by more than the kernel): every ``flash`` call of the kernel path
    is held to the plain attention on its own inputs, within the bf16
    limit; the logits to the larger of the logit limit and SDPA's own
    error against the plain path on the same tokens (SDPA in place of the
    plain attention, the rest of the plain path unchanged), and, against
    a float32 plain forward at the same weights, to within SDPA's own
    distance from it (an independent implementation's: the kernel path
    must be no farther from float32 than SDPA's)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import attention as attn
    ref_cfg = dataclasses.replace(cfg, kernel_mode="ref")
    orig, calls = attn._prefill_attention, []

    def held(c, q, k, v, *, window, causal=True):
        out = orig(c, q, k, v, window=window, causal=causal)
        want = fk.attention_plain(q, k, v, causal=causal, window=window,
                                  scale=q.shape[-1] ** -0.5)
        calls.append(assert_close_bf16(
            f"{cfg.arch} flash call {len(calls)} (window {window})", out,
            want))
        return out

    def sdpa(c, q, k, v, *, window, causal=True):
        rows = torch.arange(q.shape[2], device=q.device)[:, None]
        cols = torch.arange(q.shape[2], device=q.device)[None, :]
        mask = (cols <= rows) & (cols >= rows - window + 1 if window
                                 else True)
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)

    try:
        attn._prefill_attention = held
        kern = prefill_step_logits(cfg, params, dev, b, s)
        attn._prefill_attention = orig
        plain = prefill_step_logits(ref_cfg, params, dev, b, s)
        attn._prefill_attention = sdpa
        lib = prefill_step_logits(ref_cfg, params, dev, b, s)
    finally:
        attn._prefill_attention = orig
    # the float32 plain forward at the same weights (every bf16 matrix
    # widened exactly at its use; TF32 is off)
    f32 = prefill_step_logits(dataclasses.replace(ref_cfg, dtype="float32"),
                              params, dev, b, s)
    to_f32 = {name: float((x - f32).abs().max())
              for name, x in (("kernel", kern), ("sdpa", lib),
                              ("plain", plain))}
    if len(calls) != cfg.n_layers or not bool(torch.isfinite(kern).all()):
        raise AssertionError(f"{cfg.arch} prefill step: {len(calls)} flash "
                             f"calls held, or logits not finite")
    err = float((kern - plain).abs().max())
    lib_err = float((lib - plain).abs().max())
    limit = max(LOGIT_RTOL * float(plain.abs().max()), lib_err)
    if err > limit:
        raise AssertionError(f"{cfg.arch} prefill step logits: kernel vs "
                             f"plain max |err| {err} > {limit} (SDPA's "
                             f"{lib_err})")
    if to_f32["kernel"] > to_f32["sdpa"]:
        raise AssertionError(f"{cfg.arch} prefill step logits: the kernel "
                             f"path is {to_f32['kernel']} off the float32 "
                             f"forward, SDPA's {to_f32['sdpa']}")
    return {"prefill_step": (err, limit),
            "prefill_step_logit_limit": LOGIT_RTOL * float(
                plain.abs().max()),
            "prefill_step_sdpa_vs_plain": lib_err,
            "prefill_step_vs_float32": to_f32,
            "flash_calls_max_err": max(calls),
            "prefill_step_argmax_equal": bool(
                (kern.argmax(-1) == plain.argmax(-1)).all())}


def run_recurrent(dev, launches, card, arch, tag):
    """A recurrent model at full width and depth (rwkv6-1.6b, hymba-1.5b):
    its first contiguous prefill-chunk and decode logits and its
    ``make_prefill_step`` logits on 2 x 2048 tokens through the kernels
    against the plain path (bit-equal for RWKV, whose only kernel is the
    exact gather; for Hymba the serve logits within the bf16 logit limit
    and the prefill step's as :func:`check_deep_prefill_step`); phase 5's 8
    requests through ``PagedServeLoop``, which has no pages for recurrent
    state and falls back to the contiguous path (``paged`` False, no page
    allocated), and through ``ServeLoop``, 8/8 streams equal; the launches
    of each path (Hymba: ``flash_decode`` once a layer a decode step,
    ``flash`` once a layer a prefill step, 29 of them windowed; RWKV: the
    gather alone; neither ``flash_decode_paged`` nor ``gmm``); one traced
    decode step with all 8 slots live; the prefill step's wall."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.runtime.serve_loop import (PagedServeLoop, Request,
                                                ServeLoop)
    t0 = time.perf_counter()
    cfg, bundle, params = build_full(arch, dev)
    attn_layers = cfg.n_layers if cfg.family == "hybrid" else 0
    exact = cfg.family == "ssm"
    errs = check_logits(cfg, params, dev, (False,), with_step=exact,
                        step_shape=(PREFILL_B, PREFILL_S), exact=exact)
    if not exact:
        errs.update(check_deep_prefill_step(cfg, params, dev, PREFILL_B,
                                            PREFILL_S))
    log(f"{arch} logits kernel vs plain (max |err|, limit"
        f"{'; bit-equal required' if exact else ''}): {json.dumps(errs)}")
    out = {"params": sum(p.numel() for p in params.parameters()),
           "logits": errs}

    def read(path, st):
        pre, dec = st.prefill_steps, st.decode_steps
        return launches.read(path, ("dae_gather",), {
            "flash_decode": attn_layers * dec, "flash_decode_paged": 0,
            "flash": 0, "gmm": 0, "dae_gather": pre + dec})

    _, reqs = main_requests(cfg.vocab)
    results = {}
    for name, cls, kw in (("paged", PagedServeLoop, {"page": PAGE}),
                          ("contiguous", ServeLoop, {})):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        loop = cls(cfg, bundle, params, batch_slots=SLOTS, s_max=S_MAX,
                   chunk=CHUNK, **kw)
        res, wall = serve(loop, [dataclasses.replace(r, out=None)
                                 for r in reqs])
        st = loop.stats
        counts = read(f"{tag}_{name}_serve", st)
        tokens = sum(map(len, res.values()))
        cell = {"wall_s": round(wall, 3),
                "tokens_per_s": round(tokens / wall, 1),
                "ttft_ms_p50_p95": _ttft_ms(st, reqs),
                "prefill_steps": st.prefill_steps,
                "decode_steps": st.decode_steps,
                "peak_gib": _peak_gib()}
        if cls is PagedServeLoop:
            if loop.paged or loop.page_stats() != {"paged": False} or \
                    st.page_allocs or st.prefix_hits:
                raise AssertionError(f"{arch}: PagedServeLoop did not fall "
                                     f"back to the contiguous path "
                                     f"({loop.page_stats()}, "
                                     f"{st.page_allocs} page allocations)")
            cell.update(paged=loop.paged, page_allocs=st.page_allocs)
        results[name] = res
        out[name] = cell
        log(f"{arch} {cls.__name__}: {tokens} tokens, {st.prefill_steps} "
            f"prefill + {st.decode_steps} decode steps, {wall:.2f} s, "
            f"{tokens / wall:.1f} tokens/s, TTFT p50/p95 "
            f"{cell['ttft_ms_p50_p95']} ms, peak {cell['peak_gib']} GiB"
            f"{'' if name != 'paged' else ', paged False, 0 page allocations'}"
            f"; launches {json.dumps(counts)} ({card})")
        del loop
    same = sum(results["paged"][r] == results["contiguous"][r]
               for r in results["paged"])
    if same != len(reqs):
        raise AssertionError(f"{arch}: {same}/{len(reqs)} streams equal "
                             "across PagedServeLoop and ServeLoop")
    log(f"{arch}: {same}/{len(reqs)} streams equal across the two loops")
    out["streams_equal"] = same

    # one decode step traced with all 8 slots live
    torch.cuda.empty_cache()
    loop = ServeLoop(cfg, bundle, params, batch_slots=SLOTS, s_max=S_MAX,
                     chunk=CHUNK)
    rng = np.random.default_rng(6)
    live = [Request(rid=300 + i, prompt=rng.integers(0, cfg.vocab, size=16),
                    max_new=5) for i in range(SLOTS)]
    out["trace"] = trace_decode_steps(cfg, loop, launches, live, card,
                                      f"{tag}_traced", attn_layers, n=1)
    del loop
    torch.cuda.empty_cache()

    tok = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S)), dtype=torch.int32, device=dev)
    step = make_prefill_step(cfg)
    step(params, {"tokens": tok[:, :64]})                 # warm the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t1 = time.perf_counter()
    logits = step(params, {"tokens": tok})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = launches.read(f"{tag}_prefill_step", ("dae_gather",), {
        "flash": attn_layers, "gmm": 0, "flash_decode": 0,
        "flash_decode_paged": 0, "dae_gather": 1})
    if tuple(logits.shape) != (PREFILL_B, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill step logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    out["prefill_step"] = {"wall_s": round(wall, 4), "peak_gib": _peak_gib()}
    log(f"{arch} make_prefill_step: {PREFILL_B} x {PREFILL_S} tokens in "
        f"{wall:.3f} s; launches {json.dumps(counts)}; peak memory "
        f"{out['prefill_step']['peak_gib']} GiB ({card})")
    del params, bundle
    torch.cuda.empty_cache()
    out["phase_s"] = round(time.perf_counter() - t0, 1)
    return out


def run_recurrent_families(dev, launches, card):
    """Phase 11: rwkv6-1.6b, then hymba-1.5b."""
    t0 = time.perf_counter()
    out = {tag: run_recurrent(dev, launches, card, arch, tag)
           for arch, tag in ((RWKV6, "rwkv6"), (HYMBA, "hymba"))}
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the last three configurations (chameleon-34b, qwen2-72b,
# seamless-m4t-large-v2)
# ---------------------------------------------------------------------------


def seed_biases(params, dev, seed: int) -> int:
    """Draw every ``bq``/``bk``/``bv`` leaf N(0, 0.5) from a seeded
    generator (their init is zero, as JAX's, which would hide a missing
    add); returns how many leaves were drawn."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 0
    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.rsplit(".", 1)[-1] in ("bq", "bk", "bv"):
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.5)
                n += 1
    return n


def serve_cell(cfg, bundle, params, launches, path, loop_cls, reqs, expect,
               **kw):
    """Serve ``reqs`` on a fresh ``loop_cls`` with the counts set to 0 just
    before and read just after (``expect(stats)`` gives the required
    counts); returns the results, the loop's stats and a printable cell."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    loop = loop_cls(cfg, bundle, params, batch_slots=SLOTS, s_max=S_MAX,
                    chunk=CHUNK, **kw)
    res, wall = serve(loop, [dataclasses.replace(r, out=None) for r in reqs])
    st = loop.stats
    counts = launches.read(path, ("dae_gather",), expect(st))
    tokens = sum(map(len, res.values()))
    cell = {"wall_s": round(wall, 3), "tokens_per_s": round(tokens / wall, 1),
            "ttft_ms_p50_p95": _ttft_ms(st, reqs),
            "prefill_steps": st.prefill_steps,
            "decode_steps": st.decode_steps, "peak_gib": _peak_gib(),
            "paged": loop.paged, "page_allocs": st.page_allocs,
            "launches": counts}
    del loop
    return res, st, cell


def timed_prefill_step(cfg, params, dev, launches, path, batch, expect):
    """``make_prefill_step`` on ``batch`` after a small warm-up call,
    timed after a synchronise, its launches read; returns its output,
    wall and peak."""
    from repro_torch.launch.steps import make_prefill_step
    step = make_prefill_step(cfg)
    step(params, {k: v[:, :64] for k, v in batch.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.perf_counter()
    out = step(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches.read(path, ("dae_gather",) if "tokens" in batch
                           else ("flash",), expect)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{path}: output not finite")
    return out, {"wall_s": round(wall, 4), "peak_gib": _peak_gib(),
                 "launches": counts}


def run_tail_decoder(dev, launches, card, arch, tag, **overrides):
    """chameleon-34b or qwen2-72b at full width, the depth in
    ``overrides``: the first paged prefill-chunk and decode logits and
    ``make_prefill_step``'s logits on 2 x 2048 tokens through the kernels
    against the plain path, within the logit limit; the prefill step's
    wall (``flash`` once a layer); phase 5's 8 requests through
    ``PagedServeLoop`` (``flash_decode_paged`` once a layer a decode
    step; no ``gmm``)."""
    from repro_torch.runtime.serve_loop import PagedServeLoop
    t0 = time.perf_counter()
    cfg, bundle, params = build_full(arch, dev, **overrides)
    out = {"params": sum(p.numel() for p in params.parameters()),
           "layers": cfg.n_layers,
           "biases_drawn": seed_biases(params, dev, 7) if cfg.qkv_bias
           else 0}
    errs = check_logits(cfg, params, dev, (True,), with_step=True,
                        step_shape=(PREFILL_B, PREFILL_S))
    errs.pop("routing_flips_of_tokens", None)
    out["logits"] = errs
    log(f"{arch} ({cfg.n_layers} layers) logits kernel vs plain (max |err|, "
        f"limit): {json.dumps(errs)}")

    tok = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S)), dtype=torch.int32, device=dev)
    logits, out["prefill_step"] = timed_prefill_step(
        cfg, params, dev, launches, f"{tag}_prefill_step", {"tokens": tok},
        {"flash": cfg.n_layers, "gmm": 0, "flash_decode": 0,
         "flash_decode_paged": 0, "dae_gather": 1})
    if tuple(logits.shape) != (PREFILL_B, cfg.vocab):
        raise AssertionError(f"{arch} prefill step logits "
                             f"{tuple(logits.shape)}")
    del logits
    log(f"{arch} make_prefill_step: {PREFILL_B} x {PREFILL_S} tokens "
        f"{json.dumps(out['prefill_step'])} ({card})")

    _, reqs = main_requests(cfg.vocab)
    _, st, cell = serve_cell(
        cfg, bundle, params, launches, f"{tag}_paged_serve", PagedServeLoop,
        reqs, lambda st: {
            "flash_decode_paged": cfg.n_layers * st.decode_steps,
            "flash_decode": 0, "flash": 0, "gmm": 0,
            "dae_gather": st.prefill_steps + st.decode_steps},
        page=PAGE)
    if not cell["paged"] or not st.page_allocs:
        raise AssertionError(f"{arch}: PagedServeLoop paged nothing")
    out["paged"] = cell
    log(f"{arch} PagedServeLoop: {json.dumps(cell)} ({card})")
    del params, bundle
    torch.cuda.empty_cache()
    out["phase_s"] = round(time.perf_counter() - t0, 1)
    return out


def seamless_frames(d: int, n: int, seed: int, length: int = S_ENC):
    """``n`` seeded frame sequences of ``length`` x ``d`` float32 (the
    audio frontend's output, which the reference stubs as given
    embeddings)."""
    return np.random.default_rng(seed).standard_normal(
        (n, length, d)).astype(np.float32)


def first_logits_encdec(cfg, params, dev, frames):
    """The encoder-decoder's counterpart of :func:`first_logits`: encode
    ``frames`` (one per slot), prefill one chunk per slot, then one
    masked decode step (a one-token chunk, as serving runs it)."""
    from repro_torch.models import encdec
    rng = np.random.default_rng(3)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (SLOTS, CHUNK)),
                          dtype=torch.int32, device=dev)
    n_valid = torch.as_tensor(rng.integers(1, CHUNK + 1, SLOTS),
                              dtype=torch.int32, device=dev)
    n_valid[0] = CHUNK
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab, (SLOTS, 1)),
                          dtype=torch.int32, device=dev)
    pos = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
    caches = encdec.encdec_cache_init(cfg, SLOTS, 4 * PAGE, dev)
    with torch.inference_mode():
        enc = encdec.encode(cfg, params, torch.as_tensor(frames, device=dev))
        pre, caches = encdec.encdec_prefill(cfg, params, enc, caches, tok,
                                            pos, n_valid)
        dec, _ = encdec.encdec_prefill(cfg, params, enc, caches, nxt,
                                       n_valid, torch.ones_like(n_valid))
    return {"prefill": pre, "decode": dec}


def cross_kv_share(cfg, params, dev, frames):
    """One decode step of 8 slots over S_ENC encoder positions, timed with
    CUDA events, beside the 24 ``cross_kv`` projections it recomputes
    (as the reference does), timed alone on the same encoder output."""
    from repro_torch.models import attention as attn
    from repro_torch.models import encdec
    enc_frames = torch.as_tensor(frames, device=dev)
    tok = torch.arange(SLOTS, dtype=torch.int32, device=dev)
    pos = torch.full((SLOTS,), 16, dtype=torch.int32, device=dev)

    def events(fn, n=5):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    with torch.inference_mode():
        enc = encdec.encode(cfg, params, enc_frames)
        caches = encdec.encdec_cache_init(cfg, SLOTS, S_MAX, dev)
        step_ms = events(lambda: encdec.encdec_decode_step(
            cfg, params, enc, caches, tok, pos))
        kv_ms = events(lambda: [attn.cross_kv(cfg, blk.xattn, enc)
                                for blk in params.dec])
    return {"decode_step_ms": round(step_ms, 3),
            "cross_kv_ms": round(kv_ms, 3),
            "cross_kv_share": round(kv_ms / step_ms, 3)}


def run_seamless(dev, launches, card):
    """seamless-m4t-large-v2 at full width and depth (24 ``enc`` + 24
    ``xattn`` layers), every request carrying seeded frames of S_ENC:
    ``make_prefill_step`` (the encoder, ``flash`` with ``causal=False``)
    on 2 x 2048 frames and the first prefill-chunk and decode logits
    through the kernels against the plain path; phase 5's 8 requests
    through ``PagedServeLoop``, which must fall back to the contiguous
    path, and ``ServeLoop``, 8/8 streams equal; the launches of each loop
    (``flash``: 24 a request's encoding, 24 a decode step, 24 x CHUNK a
    prefill chunk, the cross attention one query at a time;
    ``flash_decode`` 24 a decode step); one decode step's time beside its
    ``cross_kv`` projections'."""
    from repro_torch.runtime.serve_loop import PagedServeLoop, ServeLoop
    t0 = time.perf_counter()
    cfg, bundle, params = build_full(SEAMLESS, dev)
    out = {"params": sum(p.numel() for p in params.parameters())}
    ref_cfg = dataclasses.replace(cfg, kernel_mode="ref")
    frames = torch.as_tensor(seamless_frames(cfg.d_model, PREFILL_B, 9,
                                             PREFILL_S), device=dev)
    enc, out["prefill_step"] = timed_prefill_step(
        cfg, params, dev, launches, "seamless_prefill_step",
        {"frames": frames}, {"flash": cfg.n_enc_layers, "gmm": 0,
                             "flash_decode": 0, "dae_gather": 0})
    from repro_torch.launch.steps import make_prefill_step
    plain = make_prefill_step(ref_cfg)(params, {"frames": frames})
    errs = {"prefill_step_enc_out": (float((enc - plain).abs().max()),
                                     LOGIT_RTOL * float(plain.abs().max()))}
    del enc, plain
    step_frames = seamless_frames(cfg.d_model, SLOTS, 10)
    kern = first_logits_encdec(cfg, params, dev, step_frames)
    ref = first_logits_encdec(ref_cfg, params, dev, step_frames)
    for name, a in kern.items():
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"seamless {name} logits not finite")
        errs[name] = (float((a - ref[name]).abs().max()),
                      LOGIT_RTOL * float(ref[name].abs().max()))
    out["logits"] = errs
    log(f"{SEAMLESS} encoder and logits kernel vs plain (max |err|, "
        f"limit): {json.dumps(errs)}; make_prefill_step on {PREFILL_B} x "
        f"{PREFILL_S} frames {json.dumps(out['prefill_step'])} ({card})")
    bad = {k: v for k, v in errs.items() if v[0] > v[1]}
    if bad:
        raise AssertionError(f"{SEAMLESS} kernel vs plain past the limit: "
                             f"{bad}")

    _, reqs = main_requests(cfg.vocab)
    reqs = [dataclasses.replace(r, frames=f) for r, f in
            zip(reqs, seamless_frames(cfg.d_model, len(reqs), 11))]
    n = cfg.n_layers

    def expect(st):
        return {"flash": cfg.n_enc_layers * st.admitted
                + n * (CHUNK * st.prefill_steps + st.decode_steps),
                "flash_decode": n * st.decode_steps,
                "flash_decode_paged": 0, "gmm": 0,
                "dae_gather": st.prefill_steps + st.decode_steps}

    results = {}
    for name, cls, kw in (("paged", PagedServeLoop, {"page": PAGE}),
                          ("contiguous", ServeLoop, {})):
        res, st, cell = serve_cell(cfg, bundle, params, launches,
                                   f"seamless_{name}_serve", cls, reqs,
                                   expect, **kw)
        if cls is PagedServeLoop and (cell["paged"] or st.page_allocs):
            raise AssertionError(f"{SEAMLESS}: PagedServeLoop did not fall "
                                 "back to the contiguous path")
        results[name], out[name] = res, cell
        log(f"{SEAMLESS} {cls.__name__} (frames of {S_ENC}): "
            f"{json.dumps(cell)} ({card})")
    same = sum(results["paged"][r] == results["contiguous"][r]
               for r in results["paged"])
    if same != len(reqs):
        raise AssertionError(f"{SEAMLESS}: {same}/{len(reqs)} streams equal "
                             "across PagedServeLoop and ServeLoop")
    out["streams_equal"] = same
    out["cross_kv"] = cross_kv_share(cfg, params, dev,
                                     seamless_frames(cfg.d_model, SLOTS, 12))
    log(f"{SEAMLESS}: {same}/{len(reqs)} streams equal across the two "
        f"loops; a decode step of {SLOTS} slots against its cross_kv "
        f"projections {json.dumps(out['cross_kv'])} ({card})")
    del params, bundle
    torch.cuda.empty_cache()
    out["phase_s"] = round(time.perf_counter() - t0, 1)
    return out


def run_tail_archs(dev, launches, card):
    """Phase 12: chameleon-34b at CHAMELEON_DEPTH and qwen2-72b at
    QWEN2_DEPTH layers, then seamless-m4t-large-v2; each model freed
    before the next is built."""
    t0 = time.perf_counter()
    out = {"chameleon": run_tail_decoder(dev, launches, card, CHAMELEON,
                                         "chameleon",
                                         n_layers=CHAMELEON_DEPTH)}
    torch.cuda.empty_cache()
    out["qwen2"] = run_tail_decoder(dev, launches, card, QWEN2, "qwen2",
                                    n_layers=QWEN2_DEPTH)
    torch.cuda.empty_cache()
    out["seamless"] = run_seamless(dev, launches, card)
    log(f"phase 12 took {time.perf_counter() - t0:.1f} s")
    return out


def fresh_tune_cache() -> Path:
    """Point the tune cache at a new, empty file under ``build/``, so
    a cache left by an earlier run never decides what phases 3-7 run."""
    path = (Path(__file__).resolve().parent / "build" / "tune"
            / f"chip_smoke_{os.getpid()}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    os.environ["REPRO_TUNE_CACHE"] = str(path)
    return path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    tune_cache = fresh_tune_cache()
    from repro_torch.bench import ColdTimer
    from repro_torch.kernels.common import build_kernels

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log(f"build: {build_kernels():.1f} s")

    timer = ColdTimer(dev)
    gather, gather_rows = check_gather(dev, timer, card)
    decode = check_decode(dev, timer, 4, 128, "[qwen3-4b G4 D128]")
    # MLA decodes through the contiguous kernel at G 1 and D = dn + dr,
    # on its paged path too (src/repro/models/attention.py)
    checked = [*gather_rows, *decode,
               *check_decode(dev, timer, 3, 64, "[granite G3 D64]"),
               check_decode_single(dev, timer),
               *check_decode(dev, timer, 1, 96,
                             "[minicpm3-4b MLA G1 KVH40 D96]", kvh=40,
                             paged=False),
               *check_decode(dev, timer, 1, 96,
                             "[minicpm3-4b MLA serve S1024 V 64->96]",
                             kvh=40, paged=False, s=S_MAX, dv=64),
               *check_decode(dev, timer, 1, 192,
                             "[deepseek-v2-lite-16b MLA G1 KVH16 D192]",
                             kvh=16, paged=False),
               *check_decode(dev, timer, 1, 192,
                             "[deepseek-v2-lite-16b MLA serve S1024 V "
                             "128->192]", kvh=16, paged=False, s=S_MAX,
                             dv=128),
               # G above 8: granite-34b's 48 query heads over one KV head
               *check_decode(dev, timer, 48, 128,
                             "[granite-34b G48 KVH1 D128 S1024]", kvh=1,
                             s=S_MAX),
               # hymba-1.5b's serve decode: 25 heads over 5 KV heads
               *check_decode(dev, timer, 5, 64, "[hymba G5 KVH5 D64 S1024]",
                             kvh=5, paged=False, s=S_MAX),
               # chameleon-34b's and qwen2-72b's: 64 heads over 8 KV heads
               *check_decode(dev, timer, 8, 128,
                             "[chameleon/qwen2 G8 KVH8 D128 S1024]",
                             s=S_MAX),
               # seamless's decoder self-attention: 16 heads over 16
               *check_decode(dev, timer, 1, 64,
                             "[seamless decoder G1 KVH16 D64 S1024]",
                             kvh=16, paged=False, s=S_MAX),
               # the shapes a rank of four (model 4) decodes in the
               # sharded serve step: qwen2-72b's 2 KV heads of 8, read
               # in place from the whole cache, and granite-34b's one
               *check_decode(dev, timer, 8, 128,
                             "[qwen2-72b rank of 4: G8 KVH2 of 8 D128 "
                             "S1024, in place]", kvh=2, paged=False,
                             s=S_MAX, of_heads=8),
               *check_decode(dev, timer, 12, 128,
                             "[granite-34b rank of 4: G12 KVH1 D128 "
                             "S1024]", kvh=1, paged=False, s=S_MAX)]
    gmm_rows = [check_gmm(dev, timer, SLOTS, "[decode 8 tokens]"),
                check_gmm(dev, timer, SLOTS * CHUNK,
                          "[prefill chunk 256 tokens]"),
                check_gmm(dev, timer, PREFILL_B * PREFILL_S,
                          "[lm_apply 2x2048 tokens]")]
    # deepseek's experts: F 1408 is 5.5 tiles of 256 columns
    gmm_rows += [check_gmm(dev, timer, n, f"[deepseek {what}]",
                           DEEPSEEK_MOE)
                 for n, what in ((SLOTS, "decode 8 tokens x top-6"),
                                 (SLOTS * CHUNK, "prefill chunk 256 tokens"),
                                 (PREFILL_B * PREFILL_S,
                                  "lm_apply 2x2048 tokens"))]
    # a rank of four's experts: 10 of granite's 40
    gmm_rows += [check_gmm(dev, timer, n, f"[granite rank of 4: experts "
                           f"10 of 40, {what}]", local=10)
                 for n, what in ((SLOTS, "decode 8 tokens"),
                                 (PREFILL_B * PREFILL_S,
                                  "prefill step 2x2048 tokens"))]
    flash_rows = [
        check_flash(dev, timer, 24, 8, PREFILL_S, 64, None,
                    "[granite H24 KVH8 D64 S2048]"),
        check_flash(dev, timer, 32, 8, PREFILL_S, 128, None,
                    "[qwen3-4b H32 KVH8 D128 S2048]"),
        check_flash(dev, timer, 24, 8, PREFILL_S, 64, 512,
                    "[granite window 512]"),
        check_flash(dev, timer, 24, 8, 2000, 64, None, "[granite S2000]"),
        check_flash(dev, timer, 40, 40, PREFILL_S, 96, None,
                    "[minicpm3-4b MLA H40 D96 S2048]"),
        check_flash(dev, timer, 16, 16, PREFILL_S, 192, None,
                    "[deepseek-v2-lite-16b MLA H16 D192 S2048]"),
        check_flash(dev, timer, 48, 1, PREFILL_S, 128, None,
                    "[granite-34b H48 KVH1 D128 S2048]"),
        # a rank of four of qwen2-72b's sharded prefill step
        check_flash(dev, timer, 16, 2, PREFILL_S, 128, None,
                    "[qwen2-72b rank of 4: H16 KVH2 D128 S2048]"),
        check_flash(dev, timer, 25, 5, PREFILL_S, 64, 1024,
                    "[hymba H25 KVH5 D64 S2048 window 1024]"),
        check_flash(dev, timer, 25, 5, PREFILL_S, 64, None,
                    "[hymba global H25 KVH5 D64 S2048]"),
        # seamless-m4t-large-v2: the encoder (bidirectional), and the
        # cross attention at one query (decode, the chunked fill's
        # per-query calls) or a chunk against S_enc keys
        check_flash(dev, timer, 16, 16, PREFILL_S, 64, None,
                    "[seamless encoder H16 D64 S2048 bidirectional]",
                    causal=False),
        *(check_flash(dev, timer, 16, 16, sk, 64, None,
                      f"[seamless cross B8 H16 D64 Sq{sq} Sk{sk}]",
                      causal=False, sq=sq, b=SLOTS)
          for sq in (1, CHUNK) for sk in (1000, S_ENC)),
        check_flash(dev, timer, 16, 16, 1000, 64, None,
                    f"[seamless cross H16 D64 Sq{PREFILL_S} Sk1000]",
                    causal=False, sq=PREFILL_S)]
    checked += gmm_rows + flash_rows
    for r in checked:
        log(row_line(r, card))
    del timer
    torch.cuda.empty_cache()

    for arch in (QWEN, GRANITE, MINICPM, DEEPSEEK, GRANITE34, RWKV6, HYMBA,
                 CHAMELEON, QWEN2, SEAMLESS):
        log(f"{arch} smoke-size float32 serve: {check_small_serve(dev, arch)}"
            " tokens identical through kernels and plain path, paged and "
            "contiguous")

    launches = Launches()
    run_granite(dev, launches, card)
    torch.cuda.empty_cache()
    # phase 13 on phase 5's qwen3-4b build, before the tuner so its
    # decodes take the analytic knobs as phase 5's do
    qwen = run_qwen(dev, launches, card)
    mesh = run_mesh_serve(dev, launches, card, *qwen)
    torch.cuda.empty_cache()
    # phase 14 on the same build: the serving engine over a rank mesh
    ranked = run_rank_phase(dev, launches, card, *qwen)
    # phase 15 (a) too: the sharded prefill and serve steps
    sharded = {"serve": shard_serve_phase(dev, launches, card, *qwen[:3])}
    del qwen
    run_mla(dev, launches, card, MINICPM, "minicpm3", trace=True)
    torch.cuda.empty_cache()
    run_mla(dev, launches, card, DEEPSEEK, "deepseek")
    torch.cuda.empty_cache()
    irregular = run_irregular(dev, launches, card)
    torch.cuda.empty_cache()
    compiled = run_compiler(dev, launches, card)
    torch.cuda.empty_cache()
    # phase 9 before the tuner: the decode winners of phase 8 are timed
    # at G 4 and would dispatch at granite-34b's G 48
    run_serve_axis(dev, launches, card)
    torch.cuda.empty_cache()
    # phase 10 after phase 9 has freed granite-34b's ~65 GiB: the trainer's
    # state alone is ~49 GiB
    training = run_training(dev, launches, card)
    torch.cuda.empty_cache()
    # phase 15 (b) once phase 10's trainer is freed
    sharded["train"] = shard_train_phase(dev, launches, card,
                                         training["first_two"])
    torch.cuda.empty_cache()
    # phase 11 before the tuner, so its decodes dispatch the analytic knobs
    recurrent = run_recurrent_families(dev, launches, card)
    torch.cuda.empty_cache()
    # phase 12 too: its G 8 decodes and Sq 1 cross attention take the
    # analytic knobs
    tail = run_tail_archs(dev, launches, card)
    torch.cuda.empty_cache()
    log(f"phase 8 tunes into {tune_cache}")
    tuned = run_tuning(dev, launches, card)

    # the JSON rows: each kernel at the shape of the path that counts it;
    # gmm's and the gather's rows carry their other shapes under "cases"
    def with_cases(main, others):
        return dict(main, cases=[
            {k: v for k, v in r.items() if k not in (
                "name", "route", "source", "replaces", "library", "limit")}
            for r in others if r is not main])
    by_name = {name: [r for r in checked if r["name"] == name]
               for name in ("flash_decode", "flash_decode_paged")}
    rows = [with_cases(gather, gather_rows),
            *(with_cases(r, by_name[r["name"]]) for r in decode),
            with_cases(gmm_rows[0], gmm_rows[1:]),
            with_cases(flash_rows[0], flash_rows[1:]),
            *irregular, *compiled]
    where = {"dae_gather": "qwen3_paged_serve",
             "flash_decode_paged": "qwen3_paged_serve",
             "flash_decode": "qwen3_contiguous_serve",
             "gmm": "granite_paged_serve", "flash": "granite_prefill_step",
             "searchsorted_blocks": "irregular_binsearch",
             "hash_probe": "irregular_hashtable",
             "bsr_spmv": "irregular_spmv",
             "merge_tiles": "irregular_mergesort",
             "gather_rif": "rif_gather",
             "ring_gather": "compile_gather_paper",
             "ring_deref": "compile_frontier_gather_small",
             "ring_chase": "compile_binsearch_for_paper"}
    out = []
    for r in rows:
        r = {k: v for k, v in r.items()
             if k not in ("case", "library", "limit")}
        r["launches"] = launches.paths[where[r["name"]]][r["name"]]
        if r["name"] in ("dae_gather", "flash_decode_paged"):
            # phase 14's serving engine on a rank mesh runs them too
            r["launches"] += launches.paths["qwen3_rank1_serve"][r["name"]]
        if r["name"] in ("dae_gather", "flash", "flash_decode"):
            # and phase 15's sharded steps
            r["launches"] += sum(launches.paths[p][r["name"]] for p in (
                "qwen3_shard_prefill", "qwen3_shard_serve"))
        out.append(r)
    log("launches by path: " + json.dumps(launches.paths))
    log("tuned: " + json.dumps(tuned))
    log("training: " + json.dumps(training))
    log("recurrent: " + json.dumps(recurrent))
    log("tail: " + json.dumps(tail))
    log("mesh: " + json.dumps(mesh))
    log("ranks: " + json.dumps(ranked))
    log("sharded steps: " + json.dumps(sharded))
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
