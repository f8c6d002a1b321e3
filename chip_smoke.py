#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. print the card's name and power limit, and the torch and CUDA
   versions;
2. build every CUDA kernel of ``src/repro_torch/csrc`` with ``nvcc``
   (one process per source, all started together);
3. hold each kernel against its plain PyTorch version at the main path's
   shapes, and time kernel, plain version and a library yardstick with
   CUDA events (each launch timed with a cold L2);
4. build qwen3-4b at full width (36 layers, bf16) from a seeded
   ``torch.Generator``; check the first paged and contiguous prefill and
   decode logits through the kernels against the plain path; check
   that a smoke-sized float32 model serves the same tokens through the
   kernels as through the plain path;
5. the main path: serve 8 requests (prompts of 1-700 tokens, 32 new
   tokens each) with ``PagedServeLoop`` (8 slots, s_max 1024, page 16,
   chunk 32), serve one prompt again to exercise prefix reuse, then the
   same requests through the contiguous ``ServeLoop``; every kernel must
   have launched in these runs.

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
L2_FLUSH_BYTES = 256 * 2**20   # > the 50 MB L2
BF16_RTOL = 2.0 ** -7          # one bf16 ulp, relative
BF16_ATOL = 1e-3
# Logits are bf16 products: a rounding flip upstream moves a logit by
# an ulp of its own size.  Allow 4 bf16 ulps at the largest logit.
LOGIT_RTOL = 2.0 ** -5
SLEEP_CYCLES = 2_000_000       # ~1 ms of device spin before each timing

SLOTS, S_MAX, PAGE, CHUNK, MAX_NEW = 8, 1024, 16, 32, 32


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class ColdTimer:
    """Mean device time of ``fn`` over ``iters`` calls, each timed with
    its own CUDA events after the L2 cache was overwritten.  The device
    spins for ``SLEEP_CYCLES`` before each start event, so the host has
    enqueued the timed work before the device reaches it and host-side
    launch cost stays outside the events."""

    def __init__(self, device):
        self.flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                                 device=device)

    def __call__(self, fn, iters: int = 30, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


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


def _decode_inputs(dev, gen, b, kvh, g, d, s):
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[:4] = torch.tensor([1, PAGE, PAGE + 1, s], dtype=torch.int32)
    q = torch.randn((b, kvh, g, d), generator=gen, device=dev
                    ).to(torch.bfloat16)
    return q, lengths


def _decode_cost(lengths, kvh, g, d, esize, extra_bytes):
    tokens = float(lengths.sum())
    nbytes = tokens * kvh * d * esize * 2 + extra_bytes
    return bound(nbytes, tokens * kvh * g * d * 4)


def _sdpa(q, kc, vc, lengths):
    b, kvh, g, d = q.shape
    mask = (torch.arange(kc.shape[2], device=q.device)[None, :]
            < lengths[:, None].long())[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q.reshape(b, kvh * g, 1, d), kc, vc, attn_mask=mask,
        scale=d ** -0.5, enable_gqa=True)


def check_decode(dev, timer):
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device=dev).manual_seed(2)
    b, kvh, g, d, s = SLOTS, 8, 4, 128, 2048
    npb = s // PAGE
    scale = d ** -0.5
    q, lengths = _decode_inputs(dev, gen, b, kvh, g, d, s)
    rows = []

    kc = torch.randn((b, kvh, s, d), generator=gen, device=dev
                     ).to(torch.bfloat16)
    vc = torch.randn((b, kvh, s, d), generator=gen, device=dev
                     ).to(torch.bfloat16)
    got = fk.flash_decode(q, kc, vc, lengths, scale=scale)
    want = fk.decode_plain(q, kc, vc, lengths, scale=scale)
    torch.cuda.synchronize()
    err = assert_close_bf16("flash_decode", got, want)
    b_ms, b_by = _decode_cost(lengths, kvh, g, d, 2, 2 * q.numel() * 2 + 4 * b)
    rows.append({"name": "flash_decode", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_decode.cu",
                 "replaces":
                     "src/repro/kernels/flash_attention/kernel.py:175",
                 "max_abs_err": err,
                 "ms": timer(lambda: fk.flash_decode(q, kc, vc, lengths,
                                                     scale=scale)),
                 "plain_ms": timer(lambda: fk.decode_plain(
                     q, kc, vc, lengths, scale=scale)),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": timer(lambda: _sdpa(q, kc, vc, lengths))})
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
    err = assert_close_bf16("flash_decode_paged", got, want)
    blocks = float(((lengths + PAGE - 1) // PAGE).sum())
    b_ms, b_by = _decode_cost(lengths, kvh, g, d, 2,
                              2 * q.numel() * 2 + 4 * b + 4 * blocks * kvh)
    kcg, vcg = fk.pages_to_cache(kp, table), fk.pages_to_cache(vp, table)
    rows.append({"name": "flash_decode_paged", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_decode.cu",
                 "replaces":
                     "src/repro/kernels/flash_attention/kernel.py:233",
                 "max_abs_err": err,
                 "ms": timer(lambda: fk.flash_decode_paged(
                     q, kp, vp, table, lengths, scale=scale)),
                 "plain_ms": timer(lambda: fk.decode_paged_plain(
                     q, kp, vp, table, lengths, scale=scale)),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": timer(lambda: _sdpa(q, kcg, vcg, lengths))})
    return rows


# ---------------------------------------------------------------------------
# phase 4: the model through the kernels against the plain path
# ---------------------------------------------------------------------------


def first_logits(cfg, params, dev, paged: bool):
    """Prefill one chunk per slot, then one decode step; returns both
    logits.  Inputs are seeded, so two calls see the same data."""
    from repro_torch.models import transformer as t
    rng = np.random.default_rng(3)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (SLOTS, CHUNK)),
                          dtype=torch.int32, device=dev)
    n_valid = torch.as_tensor(rng.integers(1, CHUNK + 1, SLOTS),
                              dtype=torch.int32, device=dev)
    n_valid[0] = CHUNK
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
        nxt = pre.argmax(-1).to(torch.int32)[:, None]
        dec, _ = t.lm_prefill(cfg, params, caches, nxt, n_valid,
                              torch.ones_like(n_valid), **kw)
    return pre, dec


def check_logits(cfg, params, dev):
    ref_cfg = dataclasses.replace(cfg, kernel_mode="ref")
    out = {}
    for paged in (True, False):
        kind = "paged" if paged else "contiguous"
        k_pre, k_dec = first_logits(cfg, params, dev, paged)
        r_pre, r_dec = first_logits(ref_cfg, params, dev, paged)
        for name, a, b in (("prefill", k_pre, r_pre),
                           ("decode", k_dec, r_dec)):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{kind} {name} logits not finite")
            err = float((a - b).abs().max())
            limit = LOGIT_RTOL * float(b.abs().max())
            if err > limit:
                raise AssertionError(f"{kind} {name} logits: kernel vs plain "
                                     f"max |err| {err} > {limit}")
            out[f"{kind}_{name}"] = (err, limit)
    return out


def check_small_serve(dev):
    """Smoke-sized float32 qwen3 on the card: the kernels must serve the
    same tokens as the plain path, paged and contiguous."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serve_loop import (PagedServeLoop, Request,
                                                ServeLoop)
    streams = {}
    for mode in ("kernel", "ref"):
        cfg = get_config("qwen3-4b", smoke=True, kernel_mode=mode)
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
            raise AssertionError(f"smoke serve {key} tokens differ from the "
                                 "plain paged path")
    return sum(len(v) for v in ref.values())


# ---------------------------------------------------------------------------
# phase 5: the main path
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import build_kernels
    from repro_torch.kernels.dae_gather import kernel as gk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serve_loop import (PagedServeLoop, Request,
                                                ServeLoop)

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
    rows = [check_gather(dev, timer), *check_decode(dev, timer)]
    for r in rows:
        log(f"kernel {r['name']}: max_abs_err {r['max_abs_err']} ms "
            f"{r['ms']:.4f} plain {r['plain_ms']:.4f} library "
            f"{r['library_ms']:.4f} bound {r['bound_ms']:.4f} ({card})")
    del timer
    torch.cuda.empty_cache()

    small_tokens = check_small_serve(dev)
    log(f"smoke-size float32 serve: {small_tokens} tokens identical through "
        "kernels and plain path, paged and contiguous")

    cfg = get_config("qwen3-4b")
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"qwen3-4b full width: {sum(p.numel() for p in params.parameters())}"
        f" parameters built in {time.perf_counter() - t0:.1f} s")
    errs = check_logits(cfg, params, dev)
    log("logits kernel vs plain (max |err|, limit): " + json.dumps(errs))

    prompts, reqs = main_requests(cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    counted = {"dae_gather": gk.gather_rows, "flash_decode": fk.flash_decode,
               "flash_decode_paged": fk.flash_decode_paged}
    launches = {}

    for fn in counted.values():
        fn.launches = 0
    paged = PagedServeLoop(cfg, bundle, params, batch_slots=SLOTS,
                           s_max=S_MAX, chunk=CHUNK, page=PAGE)
    res_p, wall_p = serve(paged, reqs)
    st = paged.stats
    steps = (st.prefill_steps, st.decode_steps)
    again = [Request(rid=100, prompt=prompts[1], max_new=MAX_NEW)]
    _, wall_again = serve(paged, again)
    if st.prefix_hits < 1:
        raise AssertionError("the repeated prompt reused no prefix")
    launches["dae_gather"] = gk.gather_rows.launches
    launches["flash_decode_paged"] = fk.flash_decode_paged.launches
    log(f"PagedServeLoop: {sum(map(len, res_p.values()))} tokens, "
        f"{steps[0]} prefill + {steps[1]} decode steps, {wall_p:.2f} s; "
        f"repeat of a 700-token prompt {wall_again:.2f} s, "
        f"{st.prefill_steps - steps[0]} prefill + "
        f"{st.decode_steps - steps[1]} decode steps, "
        f"{st.prefix_tokens_reused} tokens reused; launches over both "
        f"{json.dumps({k: f.launches for k, f in counted.items()})} ({card})")
    del paged
    torch.cuda.empty_cache()

    for fn in counted.values():
        fn.launches = 0
    contig = ServeLoop(cfg, bundle, params, batch_slots=SLOTS, s_max=S_MAX,
                       chunk=CHUNK)
    res_c, wall_c = serve(contig, [dataclasses.replace(r, out=None)
                                   for r in reqs])
    launches["flash_decode"] = fk.flash_decode.launches
    st = contig.stats
    same = sum(res_c[r] == res_p[r] for r in res_c)
    log(f"ServeLoop: {sum(map(len, res_c.values()))} tokens, "
        f"{st.prefill_steps} prefill + {st.decode_steps} decode steps, "
        f"{wall_c:.2f} s; {same}/{len(res_c)} streams equal to the paged "
        f"loop's; launches "
        f"{json.dumps({k: f.launches for k, f in counted.items()})} ({card})")
    log(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({card})")

    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
