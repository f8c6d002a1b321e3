#!/usr/bin/env python3
"""The sharded steps over several cards: tensor parallelism over
``model`` and FSDP over ``data`` at full width.

    python3 tools/shard_dist.py            # four cards, one rank a card
    python3 tools/shard_dist.py --cpu 4    # rehearsal: 4 gloo ranks, CPU

On the cards it builds the CUDA kernels once, then on card 0 of this
process computes the one-card references from seeded weights:

- qwen2-72b at QWEN2_CHECK layers (its full width, bf16): the prefill
  step's logits on 2 x 2048 tokens and SERVE_STEPS greedy serve steps of
  8 rows at s_max 1024 (the tokens, and each step's logits);
- qwen3-4b training at QWEN3_CHECK layers (float32 state, ``ref``
  mode): TRAIN_STEPS AdamW steps on one 4 x 1024 batch (losses, grad
  norms).

Then it spawns one rank a card (``nccl``); each draws its shards of the
same weights (``launch/steps.py::init_shards``) and runs, on a (1, n)
mesh, qwen2-72b's prefill step and serve steps at QWEN2_CHECK layers
and then at its full 80 layers (137.75 GiB in bf16, which no single card
holds); on a (2, n / 2) mesh qwen3-4b's train steps at QWEN3_CHECK
layers (losses against card 0's) and at full depth (losses falling).

At QWEN2_CHECK layers the serve steps run twice: greedy, and fed card
0's greedy tokens.  The checks: the prefill logits and every fed step's
logits within the logit limit of card 0's; where a fed step's argmax
differs from card 0's, card 0's own top two logits lie within twice the
step's logit error (a near tie, which bf16 sums in another order may
resolve either way); and every rank's greedy tokens equal.  How many
greedy steps each row keeps equal to card 0's is printed.

Per cell and card it prints the peak GiB, the wall of a step (host clock
after a synchronise; serve: the median over the steps), the bytes each
rank hands to collectives in one step (counted at the calls), and the
device ms of the ``nccl`` kernels in one step (``torch.profiler``; "not
measured" where the trace holds no device time).  The summary also goes
to ``chiprun_out/shard_dist.json``.  Exit 1 if a check fails.

``--cpu N`` runs the same cells on N gloo ranks with the smoke models
(float32, the plain path, short sequences; no times are device times).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

QWEN2, QWEN3 = "qwen2-72b", "qwen3-4b"
QWEN2_CHECK, QWEN3_CHECK = 12, 4
PREFILL_B, SERVE_ROWS, SERVE_STEPS = 2, 8, 32
TRAIN_B, TRAIN_STEPS, TRAIN_LR = 4, 4, 3e-4
LOGIT_RTOL = 2.0 ** -5           # chip_smoke.py's logit limit
TRAIN_CHECK_RTOL = 1e-2          # bf16 compute, other sum orders


def sizes(smoke: bool):
    """(prefill length, s_max, train length)."""
    return (32, 64, 32) if smoke else (2048, 1024, 1024)


def config(arch: str, smoke: bool, layers: int = 0, **overrides):
    from repro_torch.configs import get_config
    if layers and not smoke:
        overrides["n_layers"] = layers
    return get_config(arch, smoke=smoke, **overrides)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _peak_gib(dev):
    return (round(torch.cuda.max_memory_allocated(dev) / 2**30, 3)
            if dev.type == "cuda" else None)


# -- what the collectives move ---------------------------------------------


@contextlib.contextmanager
def counted_collectives(tally):
    """Add to ``tally["bytes"]`` the bytes of every all-reduce (its
    tensor), all-gather (its output) and reduce-scatter (its input) that
    ``parallel/collectives.py`` issues inside the block."""
    import torch.distributed as dist

    from repro_torch.parallel import collectives as c
    saved = (dist.all_reduce, c._gather_into, c._scatter_into)

    def nbytes(t):
        return t.numel() * t.element_size()

    def all_reduce(t, *a, **k):
        tally["bytes"] += nbytes(t)
        return saved[0](t, *a, **k)

    def gather(out, src, *a, **k):
        tally["bytes"] += nbytes(out)
        return saved[1](out, src, *a, **k)

    def scatter(out, src, *a, **k):
        tally["bytes"] += nbytes(src)
        return saved[2](out, src, *a, **k)
    dist.all_reduce, c._gather_into, c._scatter_into = \
        all_reduce, gather, scatter
    try:
        yield tally
    finally:
        dist.all_reduce, c._gather_into, c._scatter_into = saved


def nccl_ms(fn, dev):
    """Device ms of the ``nccl`` kernels of one ``fn()`` (and of all
    kernels), from ``torch.profiler``; ``None`` where the trace holds no
    device time."""
    if dev.type != "cuda":
        return None, None
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    comm = total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        total += t
        if "nccl" in e.key.lower():
            comm += t
    if total == 0:
        return None, None
    return round(comm / 1e3, 3), round(total / 1e3, 3)


# -- one card's references ----------------------------------------------------


def serve_reference(cfg, dev, smoke):
    """One card's prefill logits, and its greedy serve steps: the tokens
    and each step's logits."""
    from repro_torch.launch import steps
    pre_s, s_max, _ = sizes(smoke)
    bundle = steps.build_model(cfg, dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    tok = torch.as_tensor(_tokens(cfg.vocab, (PREFILL_B, pre_s), 1),
                          device=dev)
    with torch.inference_mode():
        pre = steps.make_prefill_step(cfg, dev)(params, {"tokens": tok})
    step = steps.make_serve_step(cfg, dev)
    cache = bundle.cache_init(SERVE_ROWS, s_max)
    t = torch.as_tensor(_tokens(cfg.vocab, (SERVE_ROWS,), 2), device=dev)
    pos = torch.zeros(SERVE_ROWS, dtype=torch.int32, device=dev)
    tokens, logits_by_step = [], []
    for _ in range(SERVE_STEPS):
        logits, cache = step(params, cache, t, pos)
        logits_by_step.append(logits.float().cpu().numpy())
        t, pos = logits.argmax(-1).to(torch.int32), pos + 1
        tokens.append(t.tolist())
    return {"prefill": pre.float().cpu().numpy(), "logits": logits_by_step,
            "tokens": tokens}


def train_reference(cfg, dev, smoke):
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.optim import AdamW
    params = steps.build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(0), dtype=cfg.pdtype)
    opt = AdamW(lr=TRAIN_LR)
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt, dev)
    batch = SyntheticLM(cfg.vocab, sizes(smoke)[2], TRAIN_B).batch_at(0)
    rows = []
    for _ in range(TRAIN_STEPS):
        params, state, m = step(params, state, batch)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
    return rows


# -- the ranks ----------------------------------------------------------------


def serve_cell(cfg, mesh, smoke, feed=None):
    """The sharded prefill and serve steps on ``mesh`` from
    ``init_shards``' weights: greedy serve steps, and with ``feed`` (one
    card's greedy tokens) the same steps fed those tokens, whose logits
    rank 0 returns."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    from repro_torch.models.transformer import lm_cache_init
    from repro_torch.parallel.collectives import all_gather
    from repro_torch.parallel.sharding import cache_shardings, place
    dev = mesh.device
    pre_s, s_max, _ = sizes(smoke)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    (params, init_s) = _timed(lambda: steps.init_shards(
        cfg, torch.Generator(device=dev).manual_seed(0), mesh), dev)
    out = {"layers": cfg.n_layers, "init_s": round(init_s, 2),
           "param_gib_per_card": round(sum(
               p.numel() * p.element_size() for p in params.parameters())
               / 2**30, 3)}
    pstep, _ = steps.shard_prefill_step(
        cfg, mesh, InputShape("prefill", pre_s, PREFILL_B, "prefill"))
    tok = torch.as_tensor(_tokens(cfg.vocab, (PREFILL_B, pre_s), 1),
                          device=dev)
    pstep(params, {"tokens": tok[:, :16]})
    tally = {"bytes": 0}
    with counted_collectives(tally):
        pre, wall = _timed(lambda: pstep(params, {"tokens": tok}), dev)
    out["prefill"] = {"tokens": [PREFILL_B, pre_s], "wall_s": round(wall, 4),
                      "collective_bytes": tally["bytes"]}
    out["prefill"]["nccl_ms"], out["prefill"]["device_ms"] = nccl_ms(
        lambda: pstep(params, {"tokens": tok}), dev)
    sstep, (_, cache_specs, _, _) = steps.shard_serve_step(
        cfg, mesh, InputShape("decode", s_max, SERVE_ROWS, "decode"))
    cache = place(lm_cache_init(cfg, SERVE_ROWS, s_max, dev), mesh,
                  cache_shardings(cache_specs, mesh))
    v_cut = cfg.vocab % mesh.shape["model"] == 0
    start = torch.as_tensor(_tokens(cfg.vocab, (SERVE_ROWS,), 2),
                            device=dev)

    def run(forced):
        cache = place(lm_cache_init(cfg, SERVE_ROWS, s_max, dev), mesh,
                      cache_shardings(cache_specs, mesh))
        t = start
        pos = torch.zeros(SERVE_ROWS, dtype=torch.int32, device=dev)
        walls, tokens, logits_by_step, tallies = [], [], [], []
        for i in range(SERVE_STEPS):
            tally = {"bytes": 0}
            with counted_collectives(tally):
                (logits, cache), wall = _timed(
                    lambda: sstep(params, cache, t, pos), dev)
            walls.append(wall)
            tallies.append(tally["bytes"])
            whole = (all_gather(logits, mesh, "model", dim=1) if v_cut
                     else logits)
            if mesh.rank == 0 and forced:
                logits_by_step.append(whole.float().cpu().numpy())
            t = whole.argmax(-1).to(torch.int32)
            tokens.append(t.tolist())
            if forced:
                t = torch.as_tensor(feed[i], dtype=torch.int32, device=dev)
            pos = pos + 1
        return cache, t, pos, walls, tokens, logits_by_step, tallies

    cache, t, pos, walls, tokens, _, tallies = run(False)
    out["serve"] = {"steps": SERVE_STEPS, "rows": SERVE_ROWS,
                    "s_max": s_max,
                    "step_ms_median": round(1e3 * float(np.median(
                        walls[1:])), 3),
                    "collective_bytes_per_step": tallies[1]}
    out["serve"]["nccl_ms"], out["serve"]["device_ms"] = nccl_ms(
        lambda: sstep(params, cache, t, pos), dev)
    out["peak_gib"] = _peak_gib(dev)
    result = {"summary": out, "tokens": tokens}
    if feed is not None:
        del cache
        _, _, _, _, result["forced_tokens"], forced, _ = run(True)
        if mesh.rank == 0:
            result["forced_logits"] = forced
    if mesh.rank == 0:
        result["prefill"] = pre.float().cpu().numpy()
    del params
    return result


def train_cell(cfg, mesh, smoke):
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.optim import AdamW
    dev = mesh.device
    seq = sizes(smoke)[2]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    params = steps.init_shards(cfg, torch.Generator(device=dev).manual_seed(
        0), mesh, dtype=cfg.pdtype)
    opt = AdamW(lr=TRAIN_LR)
    state = opt.init(params)
    step, _ = steps.shard_train_step(
        cfg, mesh, InputShape("train", seq, TRAIN_B, "train"),
        optimizer=opt)
    batch = SyntheticLM(cfg.vocab, seq, TRAIN_B).batch_at(0)
    n = TRAIN_B // mesh.shape["data"]
    i = mesh.axis_index("data")
    batch = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
    rows, walls = [], []
    for _ in range(TRAIN_STEPS):
        tally = {"bytes": 0}
        with counted_collectives(tally):
            (params, state, m), wall = _timed(
                lambda: step(params, state, batch), dev)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
        walls.append(wall)
    out = {"layers": cfg.n_layers, "tokens_per_step": TRAIN_B * seq,
           "losses": rows,
           "step_s_median": round(float(np.median(walls[1:])), 4),
           "collective_bytes_per_step": tally["bytes"],
           "peak_gib": _peak_gib(dev)}
    out["nccl_ms"], out["device_ms"] = nccl_ms(
        lambda: step(params, state, batch), dev)
    del params, state
    return out


def rank_cells(smoke: bool, feed):
    """Every cell on this rank; ``feed`` is one card's greedy tokens at
    QWEN2_CHECK layers."""
    from repro_torch.launch.mesh import make_debug_mesh, world_size
    n = world_size()
    tp = make_debug_mesh((1, n), ("data", "model"), ranks=True)
    fsdp = make_debug_mesh((2, n // 2), ("data", "model"), ranks=True)
    out = {"qwen2_check": serve_cell(config(QWEN2, smoke, QWEN2_CHECK), tp,
                                     smoke, feed)}
    out["qwen2_full"] = serve_cell(config(QWEN2, smoke), tp, smoke)
    out["qwen2_full"].pop("prefill", None)
    out["qwen3_train_check"] = train_cell(
        config(QWEN3, smoke, QWEN3_CHECK, kernel_mode="ref"), fsdp, smoke)
    out["qwen3_train_full"] = train_cell(
        config(QWEN3, smoke, kernel_mode="ref"), fsdp, smoke)
    return out


def _logit_err(got, want):
    return float(np.abs(got - want).max()), \
        LOGIT_RTOL * float(np.abs(want).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="rehearse on N gloo ranks with the smoke models")
    args = ap.parse_args()
    smoke = args.cpu > 0
    if not smoke and not torch.cuda.is_available():
        print("shard_dist: no CUDA card (use --cpu N to rehearse)",
              file=sys.stderr)
        return 1
    if not smoke and torch.cuda.device_count() < 4:
        print("shard_dist: needs four CUDA cards", file=sys.stderr)
        return 1
    from repro_torch.launch.spawn import spawn
    summary = {}
    if smoke:
        cards, dev = args.cpu, torch.device("cpu")
        summary["card"] = "cpu (rehearsal: no device metric)"
    else:
        import chip_smoke as cs
        from repro_torch.kernels.common import build_kernels
        cards, dev = 4, torch.device("cuda", 0)
        summary["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        cs.fresh_tune_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        summary["build_s"] = round(build_kernels(), 1)
    print(summary["card"], flush=True)
    t0 = time.perf_counter()
    ref_serve = serve_reference(config(QWEN2, smoke, QWEN2_CHECK), dev, smoke)
    if not smoke:
        torch.cuda.empty_cache()
    ref_train = train_reference(config(QWEN3, smoke, QWEN3_CHECK,
                                       kernel_mode="ref"), dev, smoke)
    if not smoke:
        torch.cuda.empty_cache()
    summary["references_s"] = round(time.perf_counter() - t0, 1)

    t0 = time.perf_counter()
    ranks = spawn(rank_cells, cards, smoke, ref_serve["tokens"],
                  backend="gloo" if smoke else "nccl", timeout=900)
    summary["ranks_s"] = round(time.perf_counter() - t0, 1)
    check = ranks[0]["qwen2_check"]
    err, limit = _logit_err(check["prefill"], ref_serve["prefill"])
    # the same inputs a step (one card's greedy tokens): every step's
    # logits within the logit limit, and where the argmax differs, the
    # card's own top two within the error
    errs = [_logit_err(g, w) for g, w in zip(check["forced_logits"],
                                             ref_serve["logits"])]
    want = np.array(ref_serve["tokens"])
    forced = np.array(check["forced_tokens"])
    flips = []
    for i, j in zip(*np.nonzero(forced != want)):
        top2 = np.sort(ref_serve["logits"][i][j])[-2:]
        flips.append({"step": int(i), "row": int(j),
                      "one_card_margin": float(top2[1] - top2[0]),
                      "logit_err": errs[i][0]})
    free = np.array(check["tokens"])
    first_diff = [int(np.argmax(free[:, j] != want[:, j]))
                  if (free[:, j] != want[:, j]).any() else SERVE_STEPS
                  for j in range(SERVE_ROWS)]
    ok = (err <= limit and all(e <= lim for e, lim in errs)
          and all(f["one_card_margin"] <= 2 * f["logit_err"] for f in flips)
          and all(r["qwen2_check"]["tokens"] == check["tokens"]
                  for r in ranks))
    summary["qwen2_check"] = {
        "mesh": [1, cards], "prefill_logit_err": err,
        "prefill_logit_limit": limit,
        "serve_logit_err_max": max(e for e, _ in errs),
        "serve_logit_limit_min": min(lim for _, lim in errs),
        "forced_argmax_equal": int((forced == want).sum()),
        "forced_argmax_of": int(want.size), "forced_flips": flips,
        "greedy_steps_equal_per_row": first_diff,
        "per_card": [r["qwen2_check"]["summary"] for r in ranks]}
    same = [r["qwen2_full"]["tokens"] == ranks[0]["qwen2_full"]["tokens"]
            for r in ranks]
    ok &= all(same)
    summary["qwen2_full"] = {"mesh": [1, cards],
                             "tokens_equal_across_cards": same,
                             "per_card": [r["qwen2_full"]["summary"]
                                          for r in ranks]}
    got = ranks[0]["qwen3_train_check"]["losses"]
    rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, ref_train)]
    ok &= max(rel) <= TRAIN_CHECK_RTOL
    summary["qwen3_train_check"] = {
        "mesh": [2, cards // 2], "one_card": ref_train,
        "loss_rel_diff": rel,
        "per_card": [r["qwen3_train_check"] for r in ranks]}
    full = ranks[0]["qwen3_train_full"]["losses"]
    ok &= full[-1][0] < full[0][0] and all(np.isfinite(full).flat)
    summary["qwen3_train_full"] = {
        "mesh": [2, cards // 2],
        "per_card": [r["qwen3_train_full"] for r in ranks]}
    for key in ("qwen2_check", "qwen2_full", "qwen3_train_check",
                "qwen3_train_full"):
        print(json.dumps({key: summary[key]}), flush=True)
    summary["ok"] = bool(ok)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "shard_dist.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({"ok": summary["ok"], "ranks_s": summary["ranks_s"]}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
