#!/usr/bin/env python3
"""The sharded steps over several cards: tensor parallelism over
``model`` and FSDP over ``data`` at full width, the sequence-parallel
residual stream (``act_sp``) and a ``pod`` axis.

    python3 tools/shard_dist.py            # four cards, one rank a card
    python3 tools/shard_dist.py --cells sp # only the act_sp and pod cells
    python3 tools/shard_dist.py --cpu 4    # rehearsal: 4 gloo ranks, CPU

On the cards it builds the CUDA kernels once, then on card 0 of this
process computes the one-card references from seeded weights:

- qwen2-72b at QWEN2_CHECK layers (its full width, bf16): the prefill
  step's logits on 2 x 2048 tokens and SERVE_STEPS greedy serve steps of
  8 rows at s_max 1024 (the tokens, and each step's logits);
- qwen3-4b training at QWEN3_CHECK layers (float32 state, ``ref``
  mode): TRAIN_STEPS AdamW steps on one 4 x 1024 batch (losses, grad
  norms);
- deepseek-v2-lite-16b at full depth (27 layers: MLA, 26 MoE layers of
  64 experts and 2 shared) and hymba-1.5b at full width and depth, as
  qwen2-72b's; and both at full width and F32_CHECK layers in float32
  on the plain path (``kernel_mode="ref"``), where the sharding's own
  error shows apart from bf16 rounding and MoE routing flips.

Then it spawns one rank a card (``nccl``); each draws its shards of the
same weights (``launch/steps.py::init_shards``) and runs, on a (1, n)
mesh, qwen2-72b's prefill step and serve steps at QWEN2_CHECK layers
and then at its full 80 layers (137.75 GiB in bf16, which no single card
holds); deepseek-v2-lite-16b's (16 experts and 4 MLA heads a rank at
n = 4) and hymba-1.5b's (25 query heads over 5 KV heads: at n = 4 rank
0 attends heads 0-6 over KV heads 0-1, one decode a KV group, and the
SSM's x | z re-cut); on a (2, n / 2) mesh qwen3-4b's train steps at
QWEN3_CHECK layers (losses against card 0's) and at full depth (losses
falling).

The ``sp`` cells (``--cells sp`` runs them alone): qwen2-72b at its full
80 layers on (1, n), the prefill step on 2 x 2048 with ``act_sp`` off
and on from the same shards (the two logits within the bf16 logit limit
of each other; the wall, the bytes to collectives by kind and the peak
GiB of each); qwen3-4b training at full depth on (1, n), TRAIN_STEPS
steps with ``act_sp`` off and then on from the same seeded start (the
losses, the peak GiB and the step wall of each); qwen3-4b training at
QWEN3_CHECK layers on a (2, 1, n / 2) ``("pod", "data", "model")`` mesh
against (2, n / 2) (the losses and grad norms within POD_RTOL relative:
the ``pod`` replicas against FSDP over ``data``); and hymba-1.5b at its
full 32 layers in float32 on the plain path against card 0 (held to
F32_RTOL, as the 4-layer float32 cells), which tells the cut's error
from bf16 rounding at full depth.

The serve cells held to card 0 (qwen2-72b at QWEN2_CHECK layers,
deepseek and hymba at full depth in bf16 and at F32_CHECK layers in
float32) run twice: greedy, and fed card 0's greedy tokens.  The checks,
where a cell has a limit (qwen2-72b's the bf16 logit limit, the float32
cells F32_RTOL of the largest logit): the prefill logits and every fed
step's logits within it of card 0's; where a fed step's argmax differs
from card 0's, card 0's own top two logits lie within twice the step's
logit error (a near tie, which sums in another order may resolve
either way).  The bf16 cells at full depth are compared and printed,
not held to a limit: 27 and 32 bf16 layers part further from one card
than the logit limit, through MoE routing flips and the norms (see
``PERF.md``).  Every cell: every rank's greedy tokens equal.  How many
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
DEEPSEEK, HYMBA = "deepseek-v2-lite-16b", "hymba-1.5b"
QWEN2_CHECK, QWEN3_CHECK, F32_CHECK = 12, 4, 4
PREFILL_B, SERVE_ROWS, SERVE_STEPS = 2, 8, 32
TRAIN_B, TRAIN_STEPS, TRAIN_LR = 4, 4, 3e-4
LOGIT_RTOL = 2.0 ** -5           # chip_smoke.py's logit limit
TRAIN_CHECK_RTOL = 1e-2          # bf16 compute, other sum orders
F32_RTOL = 1e-3                  # float32 sums in another order
POD_RTOL = 1e-5                  # pod replicas against FSDP, float32


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
    """Add to ``tally["bytes"]`` the payload bytes of every collective
    ``parallel/collectives.py`` issues inside the block (an all-reduce's
    tensor, an all-gather's output, a reduce-scatter's input:
    ``count_collectives``), and to ``tally["by_kind"]`` each kind's
    count, payload and ring-model link bytes."""
    from repro_torch.parallel.collectives import count_collectives
    with count_collectives() as calls:
        yield tally
    by_kind = tally.setdefault("by_kind", {})
    for c in calls:
        tally["bytes"] += c.nbytes
        row = by_kind.setdefault(c.kind, {"count": 0, "payload_bytes": 0,
                                          "link_bytes": 0.0})
        row["count"] += 1
        row["payload_bytes"] += c.nbytes
        row["link_bytes"] += c.link_bytes


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
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    n = TRAIN_B // int(np.prod([mesh.shape[a] for a in dp]))
    i = mesh.axis_index(dp)
    batch = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
    rows, walls = [], []
    for _ in range(TRAIN_STEPS):
        tally = {"bytes": 0}
        with counted_collectives(tally):
            (params, state, m), wall = _timed(
                lambda: step(params, state, batch), dev)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
        walls.append(wall)
    out = {"layers": cfg.n_layers, "act_sp": cfg.act_sp,
           "mesh": dict(mesh.shape), "tokens_per_step": TRAIN_B * seq,
           "losses": rows,
           "step_s_median": round(float(np.median(walls[1:])), 4),
           "collective_bytes_per_step": tally["bytes"],
           "collectives_by_kind": tally["by_kind"],
           "peak_gib": _peak_gib(dev)}
    out["nccl_ms"], out["device_ms"] = nccl_ms(
        lambda: step(params, state, batch), dev)
    del params, state
    return out


def sp_prefill_cell(arch, mesh, smoke):
    """``arch``'s prefill step on 2 x the prefill length with ``act_sp``
    off and then on, from one set of ``init_shards``' weights: each
    one's wall (two runs), bytes to collectives by kind and peak GiB,
    and (rank 0) both logits."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    dev = mesh.device
    pre_s = sizes(smoke)[0]
    cfg = config(arch, smoke)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    params = steps.init_shards(
        cfg, torch.Generator(device=dev).manual_seed(0), mesh)
    tok = torch.as_tensor(_tokens(cfg.vocab, (PREFILL_B, pre_s), 1),
                          device=dev)
    out = {"layers": cfg.n_layers, "mesh": dict(mesh.shape),
           "tokens": [PREFILL_B, pre_s]}
    logits = {}
    for sp in (False, True):
        step, _ = steps.shard_prefill_step(
            config(arch, smoke, act_sp=sp), mesh,
            InputShape("prefill", pre_s, PREFILL_B, "prefill"))
        step(params, {"tokens": tok[:, :16]})
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        tally = {"bytes": 0}
        with counted_collectives(tally):
            got, wall = _timed(lambda: step(params, {"tokens": tok}), dev)
        _, again = _timed(lambda: step(params, {"tokens": tok}), dev)
        out[f"act_sp_{'on' if sp else 'off'}"] = {
            "wall_s": [round(wall, 4), round(again, 4)],
            "collective_bytes": tally["bytes"],
            "collectives_by_kind": tally["by_kind"],
            "peak_gib": _peak_gib(dev)}
        logits[sp] = got.float().cpu().numpy()
        del got
    del params
    result = {"summary": out}
    if mesh.rank == 0:
        result["logits"] = logits
    return result


def checked_configs(smoke: bool, cells):
    """The serve cells compared with one card's references: key ->
    (config, the logit limit relative to the largest logit, or None
    where the cell is printed, not held to one)."""
    f32 = {"kernel_mode": "ref", "dtype": "float32"}
    out = {}
    if "tp" in cells:
        out = {"qwen2_check": (config(QWEN2, smoke, QWEN2_CHECK),
                               LOGIT_RTOL),
               "deepseek_f32": (config(DEEPSEEK, smoke, F32_CHECK, **f32),
                                F32_RTOL),
               "hymba_f32": (config(HYMBA, smoke, F32_CHECK, **f32),
                             F32_RTOL),
               "deepseek": (config(DEEPSEEK, smoke), None),
               "hymba": (config(HYMBA, smoke), None)}
    if "sp" in cells:
        out["hymba_f32_full"] = (config(HYMBA, smoke, **f32), F32_RTOL)
    return out


def rank_cells(smoke: bool, feeds, cells):
    """Every cell of ``cells`` on this rank; ``feeds`` are one card's
    greedy tokens of each checked cell."""
    from repro_torch.launch.mesh import make_debug_mesh, world_size
    n = world_size()
    tp = make_debug_mesh((1, n), ("data", "model"), ranks=True)
    fsdp = make_debug_mesh((2, n // 2), ("data", "model"), ranks=True)
    pod = make_debug_mesh((2, 1, n // 2), ("pod", "data", "model"),
                          ranks=True)
    out = {}
    if "sp" in cells:
        out["qwen2_sp"] = sp_prefill_cell(QWEN2, tp, smoke)
    out.update({key: serve_cell(cfg, tp, smoke, feeds[key])
                for key, (cfg, _) in checked_configs(smoke, cells).items()})
    if "tp" in cells:
        out["qwen2_full"] = serve_cell(config(QWEN2, smoke), tp, smoke)
        out["qwen2_full"].pop("prefill", None)
    out["qwen3_train_check"] = train_cell(
        config(QWEN3, smoke, QWEN3_CHECK, kernel_mode="ref"), fsdp, smoke)
    if "tp" in cells:
        out["qwen3_train_full"] = train_cell(
            config(QWEN3, smoke, kernel_mode="ref"), fsdp, smoke)
    if "sp" in cells:
        out["qwen3_train_pod"] = train_cell(
            config(QWEN3, smoke, QWEN3_CHECK, kernel_mode="ref"), pod, smoke)
        for sp in ("off", "on"):
            out[f"qwen3_train_tp_sp_{sp}"] = train_cell(
                config(QWEN3, smoke, kernel_mode="ref", act_sp=sp == "on"),
                tp, smoke)
    return out


def _logit_err(got, want, rtol):
    return float(np.abs(got - want).max()), \
        (rtol or LOGIT_RTOL) * float(np.abs(want).max())


def check_serve(ranks, key, ref, cards, rtol):
    """A serve cell against one card's ``ref``, held to ``rtol`` of the
    largest logit (None: printed, only the ranks' tokens held equal):
    (ok, summary)."""
    check = ranks[0][key]
    err, limit = _logit_err(check["prefill"], ref["prefill"], rtol)
    # the same inputs a step (one card's greedy tokens): every step's
    # logits within the logit limit, and where the argmax differs, the
    # card's own top two within the error
    errs = [_logit_err(g, w, rtol) for g, w in zip(check["forced_logits"],
                                                   ref["logits"])]
    want = np.array(ref["tokens"])
    forced = np.array(check["forced_tokens"])
    flips = []
    for i, j in zip(*np.nonzero(forced != want)):
        top2 = np.sort(ref["logits"][i][j])[-2:]
        flips.append({"step": int(i), "row": int(j),
                      "one_card_margin": float(top2[1] - top2[0]),
                      "logit_err": errs[i][0]})
    free = np.array(check["tokens"])
    first_diff = [int(np.argmax(free[:, j] != want[:, j]))
                  if (free[:, j] != want[:, j]).any() else SERVE_STEPS
                  for j in range(SERVE_ROWS)]
    ok = all(r[key]["tokens"] == check["tokens"] for r in ranks)
    if rtol is not None:
        ok = ok and (err <= limit and all(e <= lim for e, lim in errs)
                     and all(f["one_card_margin"] <= 2 * f["logit_err"]
                             for f in flips))
    return bool(ok), {
        "mesh": [1, cards], "held_to_limit": rtol is not None,
        "prefill_logit_err": err, "prefill_logit_limit": limit,
        "serve_logit_err_max": max(e for e, _ in errs),
        "serve_logit_limit_min": min(lim for _, lim in errs),
        "forced_argmax_equal": int((forced == want).sum()),
        "forced_argmax_of": int(want.size), "forced_flips": flips,
        "greedy_steps_equal_per_row": first_diff,
        "per_card": [r[key]["summary"] for r in ranks], "ok": bool(ok)}


def _rel(a, b):
    return abs(a - b) / abs(b)


def check_sp(ranks, summary) -> bool:
    """The ``sp`` cells: act_sp's prefill logits against its logits
    without it, act_sp's training against training without it, and the
    ``pod`` replicas against FSDP over ``data``."""
    pre = ranks[0]["qwen2_sp"]
    err, limit = _logit_err(pre["logits"][True], pre["logits"][False],
                            LOGIT_RTOL)
    ok = err <= limit
    summary["qwen2_sp"] = {
        "logit_err_on_against_off": err, "logit_limit": limit,
        "per_card": [r["qwen2_sp"]["summary"] for r in ranks]}
    off = ranks[0]["qwen3_train_tp_sp_off"]["losses"]
    on = ranks[0]["qwen3_train_tp_sp_on"]["losses"]
    rel = [_rel(a[0], b[0]) for a, b in zip(on, off)]
    ok &= max(rel) <= TRAIN_CHECK_RTOL
    summary["qwen3_train_tp_sp"] = {
        "loss_rel_diff_on_against_off": rel,
        "per_card": [{k: r[f"qwen3_train_tp_sp_{k}"] for k in ("off", "on")}
                     for r in ranks]}
    pod = ranks[0]["qwen3_train_pod"]["losses"]
    fsdp = ranks[0]["qwen3_train_check"]["losses"]
    rel = [max(_rel(a[0], b[0]), _rel(a[1], b[1]))
           for a, b in zip(pod, fsdp)]
    ok &= max(rel) <= POD_RTOL
    summary["qwen3_train_pod"] = {
        "rel_diff_against_fsdp": rel, "fsdp": fsdp,
        "per_card": [r["qwen3_train_pod"] for r in ranks]}
    return bool(ok)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="rehearse on N gloo ranks with the smoke models")
    ap.add_argument("--cells", choices=("all", "tp", "sp"), default="all",
                    help="tp: the tensor-parallel and FSDP cells; sp: the "
                    "act_sp and pod cells")
    args = ap.parse_args()
    cells = ("tp", "sp") if args.cells == "all" else (args.cells,)
    smoke = args.cpu > 0
    if not smoke and not torch.cuda.is_available():
        print("shard_dist: no CUDA card (use --cpu N to rehearse)",
              file=sys.stderr)
        return 1
    if not smoke and torch.cuda.device_count() < 4:
        print("shard_dist: needs four CUDA cards", file=sys.stderr)
        return 1
    from repro_torch.launch.spawn import spawn
    summary = {"cells": list(cells)}
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
    refs, rtols = {}, {}
    for key, (cfg, rtols[key]) in checked_configs(smoke, cells).items():
        refs[key] = serve_reference(cfg, dev, smoke)
        if not smoke:
            torch.cuda.empty_cache()
    ref_train = train_reference(config(QWEN3, smoke, QWEN3_CHECK,
                                       kernel_mode="ref"), dev, smoke)
    if not smoke:
        torch.cuda.empty_cache()
    summary["references_s"] = round(time.perf_counter() - t0, 1)

    t0 = time.perf_counter()
    ranks = spawn(rank_cells, cards, smoke,
                  {k: r["tokens"] for k, r in refs.items()}, cells,
                  backend="gloo" if smoke else "nccl", timeout=1200)
    summary["ranks_s"] = round(time.perf_counter() - t0, 1)
    ok = True
    for key, ref in refs.items():
        good, summary[key] = check_serve(ranks, key, ref, cards, rtols[key])
        ok &= good
    got = ranks[0]["qwen3_train_check"]["losses"]
    rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, ref_train)]
    ok &= max(rel) <= TRAIN_CHECK_RTOL
    summary["qwen3_train_check"] = {
        "mesh": [2, cards // 2], "one_card": ref_train,
        "loss_rel_diff": rel,
        "per_card": [r["qwen3_train_check"] for r in ranks]}
    keys = [*refs, "qwen3_train_check"]
    if "tp" in cells:
        same = [r["qwen2_full"]["tokens"] == ranks[0]["qwen2_full"]["tokens"]
                for r in ranks]
        ok &= all(same)
        summary["qwen2_full"] = {"mesh": [1, cards],
                                 "tokens_equal_across_cards": same,
                                 "per_card": [r["qwen2_full"]["summary"]
                                              for r in ranks]}
        full = ranks[0]["qwen3_train_full"]["losses"]
        ok &= full[-1][0] < full[0][0] and all(np.isfinite(full).flat)
        summary["qwen3_train_full"] = {
            "mesh": [2, cards // 2],
            "per_card": [r["qwen3_train_full"] for r in ranks]}
        keys += ["qwen2_full", "qwen3_train_full"]
    if "sp" in cells:
        ok &= check_sp(ranks, summary)
        keys += ["qwen2_sp", "qwen3_train_tp_sp", "qwen3_train_pod"]
    for key in keys:
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
