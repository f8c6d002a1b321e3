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
   CUDA events (each launch timed with a cold L2): the gather; the
   decode kernels at qwen3-4b's and granite-moe-3b-a800m's head shapes;
   ``gmm`` at granite's decode, prefill-chunk and ``lm_apply`` shapes;
   ``flash`` at granite's and qwen3-4b's widths, windowed and at a
   length that is not a multiple of the block;
4. check smoke-sized float32 models (qwen3-4b and granite) serve the
   same tokens through the kernels as through the plain path; build
   granite-moe-3b-a800m at full width (32 layers, bf16) from a seeded
   ``torch.Generator`` and check its first paged prefill-chunk and
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
   one prompt again for prefix reuse) and the contiguous ``ServeLoop``.
   Every kernel of a path must have launched in it.

It prints a ``{"kernels": [...]}`` line and, last, the contract line
``{"ok": true, "device": {...}}``.  Without a card, or without the
repository's ``src/`` beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
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
GRANITE, QWEN = "granite-moe-3b-a800m", "qwen3-4b"


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
    return (f"kernel {r['name']}{r.get('case', '')}: max_abs_err "
            f"{r['max_abs_err']} (limit {BF16_ATOL} + {BF16_RTOL} * |plain|) "
            f"ms {r['ms']:.4f} plain {r['plain_ms']:.4f} library {lib}"
            f"{r.get('library', '')} bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}) ({card})")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_gather(dev, timer):
    from repro_torch.kernels.dae_gather import kernel as gk
    gen = torch.Generator(device=dev).manual_seed(1)
    n, d, m = 151_936, 2560, SLOTS * CHUNK
    table = torch.randn((n, d), generator=gen, device=dev)
    idx = torch.randint(0, n, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[:4] = torch.tensor([0, n - 1, 7, 7], dtype=torch.int32)
    idx[-2:] = idx[4:6]                                   # repeats
    got = gk.gather_rows(table, idx)
    want = gk.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("dae_gather: kernel differs from plain")
    b_ms, b_by = bound(2 * m * d * 4 + m * 4, 0)
    return {"name": "dae_gather", "route": "cuda",
            "source": "src/repro_torch/csrc/dae_gather.cu",
            "replaces": "src/repro/kernels/dae_gather/kernel.py:49",
            "max_abs_err": 0.0,
            "ms": timer(lambda: gk.gather_rows(table, idx)),
            "plain_ms": timer(lambda: gk.gather_rows_plain(table, idx)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer(lambda: torch.index_select(table, 0,
                                                           idx))}


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


def check_decode(dev, timer, g: int, d: int, case: str):
    """Contiguous and paged decode with B 8, 8 KV heads, G query rows per
    KV head and head dim D, bf16, lengths 1, 16, 17, 2048 and four seeded
    in 1..2048, pages of 16 under a shuffled page table."""
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(2)
    b, kvh, s = SLOTS, 8, 2048
    npb = s // PAGE
    scale = d ** -0.5
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[:4] = torch.tensor([1, PAGE, PAGE + 1, s], dtype=torch.int32)
    q = torch.randn((b, kvh, g, d), generator=gen, device=dev
                    ).to(torch.bfloat16)
    rows = []

    kc = torch.randn((b, kvh, s, d), generator=gen, device=dev
                     ).to(torch.bfloat16)
    vc = torch.randn((b, kvh, s, d), generator=gen, device=dev
                     ).to(torch.bfloat16)
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

    n_pages = 1 + b * npb
    kp = torch.randn((n_pages, kvh, PAGE, d), generator=gen, device=dev
                     ).to(torch.bfloat16)
    vp = torch.randn((n_pages, kvh, PAGE, d), generator=gen, device=dev
                     ).to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    table = perm.to(torch.int32).reshape(b, npb).contiguous()
    got = fk.flash_decode_paged(q, kp, vp, table, lengths, scale=scale)
    want = fk.decode_paged_plain(q, kp, vp, table, lengths, scale=scale)
    torch.cuda.synchronize()
    err = assert_close_bf16(f"flash_decode_paged {case}", got, want)
    blocks = float(((lengths + PAGE - 1) // PAGE).sum())
    b_ms, b_by = _decode_cost(lengths, kvh, g, d, 2,
                              2 * q.numel() * 2 + 4 * b + 4 * blocks * kvh)
    kcg, vcg = fk.pages_to_cache(kp, table), fk.pages_to_cache(vp, table)
    rows.append({"name": "flash_decode_paged", "case": case, "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_decode.cu",
                 "replaces":
                     "src/repro/kernels/flash_attention/kernel.py:233",
                 "max_abs_err": err,
                 "ms": timer(lambda: fk.flash_decode_paged(
                     q, kp, vp, table, lengths, scale=scale)),
                 "plain_ms": timer(lambda: fk.decode_paged_plain(
                     q, kp, vp, table, lengths, scale=scale)),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": timer(lambda: _sdpa_decode(q, kcg, vcg,
                                                          lengths))})
    return rows


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


def check_gmm(dev, timer, tokens: int, case: str):
    """granite's expert product (D 1536, F 512, 40 experts, top-8) on the
    blocks the MoE dispatch builds for ``tokens`` tokens routed at
    random."""
    from repro_torch.kernels.grouped_matmul import kernel as mk
    from repro_torch.models import moe
    gen = torch.Generator(device=dev).manual_seed(tokens)
    e, k, d, f = 40, 8, 1536, 512
    experts = torch.rand((tokens, e), generator=gen, device=dev).topk(
        k, dim=-1).indices.to(torch.int32)
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


def check_flash(dev, timer, h, kvh, s, d, window, case: str):
    """Causal forward attention, B 2, bf16."""
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(s + d)
    b = PREFILL_B
    q = torch.randn((b, h, s, d), generator=gen, device=dev
                    ).to(torch.bfloat16)
    k = torch.randn((b, kvh, s, d), generator=gen, device=dev
                    ).to(torch.bfloat16)
    v = torch.randn((b, kvh, s, d), generator=gen, device=dev
                    ).to(torch.bfloat16)
    kw = dict(causal=True, window=window, scale=d ** -0.5)
    got = fk.flash(q, k, v, **kw)
    want = fk.attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = assert_close_bf16(f"flash {case}", got, want)
    del want
    pairs = _visible_pairs(s, window)
    b_ms, b_by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                       4.0 * b * h * pairs * d)
    if window is None:
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


def check_logits(cfg, params, dev, paged_kinds, with_step: bool):
    """Logits through the kernels against the plain path (``ref`` mode,
    dropless capacity as in serving), the plain path replaying the
    kernel path's expert routing."""
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
                                                      CHECK_B, CHECK_S)
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
        limit = LOGIT_RTOL * float(b.abs().max())
        if err > limit:
            raise AssertionError(f"{name} logits: kernel vs plain max |err| "
                                 f"{err} > {limit}")
        errs[name] = (err, limit)
    if replay.tokens:
        errs["routing_flips_of_tokens"] = (replay.flips, replay.tokens)
    return errs


def check_small_serve(dev, arch):
    """Smoke-sized float32 model on the card: the kernels must serve the
    same tokens as the plain path, paged and contiguous."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serve_loop import (PagedServeLoop, Request,
                                                ServeLoop)
    streams = {}
    for mode in ("kernel", "ref"):
        cfg = get_config(arch, smoke=True, kernel_mode=mode)
        bundle = build_model(cfg, dev)
        params = bundle.init(torch.Generator(device=dev).manual_seed(0))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, size=n)
                   for n in (12, 3, 25, 7, 1, 18)]
        for cls in (PagedServeLoop, ServeLoop):
            kw = {"page": 8} if cls is PagedServeLoop else {}
            loop = cls(cfg, bundle, params, batch_slots=4, s_max=40,
                       chunk=16, **kw)
            streams[mode, cls.__name__] = loop.run(
                [Request(rid=i, prompt=p, max_new=8)
                 for i, p in enumerate(prompts)])
    ref = streams["ref", "PagedServeLoop"]
    for key, res in streams.items():
        if res != ref:
            raise AssertionError(f"{arch} smoke serve {key} tokens differ "
                                 "from the plain paged path")
    return sum(len(v) for v in ref.values())


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
        from repro_torch.kernels.dae_gather import kernel as gk
        from repro_torch.kernels.flash_attention import kernel as fk
        from repro_torch.kernels.grouped_matmul import kernel as mk
        self.fns = {"dae_gather": gk.gather_rows, "gmm": mk.gmm,
                    "flash": fk.flash, "flash_decode": fk.flash_decode,
                    "flash_decode_paged": fk.flash_decode_paged}
        self.paths = {}

    def reset(self):
        for fn in self.fns.values():
            fn.launches = 0

    def read(self, path, required):
        counts = {k: fn.launches for k, fn in self.fns.items()}
        self.paths[path] = counts
        missing = [k for k in required if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{path}: kernels never launched: "
                                 f"{missing}")
        return counts


def build_full(arch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config(arch)
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
    _, wall_again = serve(paged, again)
    if st.prefix_hits < 1:
        raise AssertionError("the repeated prompt reused no prefix")
    counts = launches.read("qwen3_paged_serve",
                           ("flash_decode_paged", "dae_gather"))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
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
    gather = check_gather(dev, timer)
    decode = check_decode(dev, timer, 4, 128, "[qwen3-4b G4 D128]")
    checked = [gather, *decode,
               *check_decode(dev, timer, 3, 64, "[granite G3 D64]")]
    gmm_rows = [check_gmm(dev, timer, SLOTS, "[decode 8 tokens]"),
                check_gmm(dev, timer, SLOTS * CHUNK,
                          "[prefill chunk 256 tokens]"),
                check_gmm(dev, timer, PREFILL_B * PREFILL_S,
                          "[lm_apply 2x2048 tokens]")]
    flash_rows = [
        check_flash(dev, timer, 24, 8, PREFILL_S, 64, None,
                    "[granite H24 KVH8 D64 S2048]"),
        check_flash(dev, timer, 32, 8, PREFILL_S, 128, None,
                    "[qwen3-4b H32 KVH8 D128 S2048]"),
        check_flash(dev, timer, 24, 8, PREFILL_S, 64, 512,
                    "[granite window 512]"),
        check_flash(dev, timer, 24, 8, 2000, 64, None, "[granite S2000]")]
    checked += gmm_rows + flash_rows
    for r in checked:
        log(row_line(r, card))
    del timer
    torch.cuda.empty_cache()

    for arch in (QWEN, GRANITE):
        log(f"{arch} smoke-size float32 serve: {check_small_serve(dev, arch)}"
            " tokens identical through kernels and plain path, paged and "
            "contiguous")

    launches = Launches()
    run_granite(dev, launches, card)
    torch.cuda.empty_cache()
    run_qwen(dev, launches, card)

    # the JSON rows: each kernel at the shape of the path that counts it
    rows = [gather, *decode, gmm_rows[0], flash_rows[0]]
    where = {"dae_gather": "qwen3_paged_serve",
             "flash_decode_paged": "qwen3_paged_serve",
             "flash_decode": "qwen3_contiguous_serve",
             "gmm": "granite_paged_serve", "flash": "granite_prefill_step"}
    out = []
    for r in rows:
        r = {k: v for k, v in r.items() if k not in ("case", "library")}
        r["launches"] = launches.paths[where[r["name"]]][r["name"]]
        out.append(r)
    log("launches by path: " + json.dumps(launches.paths))
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
