"""The dry-run (``repro_torch.launch.dryrun``, ``repro_torch.launch.
hlo_stats``) against the JAX package's, on the CPU.

- ``collective_stats`` on ``Collective`` records of each kind, on lines
  of 2, 4 and 8 slots, equals JAX's ``collective_stats`` on the HLO
  lines of the same collectives exactly (a reduce-scatter's payload is
  its result's bytes), and so does a list of every kind together;
  ``broadcast`` keeps a key of its own.
- ``count_ops`` on an ``OpLog`` of a few ops, and the launches of the
  kernel wrappers (none on the CPU).
- One JAX subprocess for the file compiles the train, prefill and serve
  steps of granite-moe-3b-a800m's smoke model on JAX's
  ``tests/test_distributed.py`` mesh (2, 4) with 8 forced host devices.
  The port's dry-run of the same cells, as each of the 8 ranks, gives
  JAX's ``argument_size_in_bytes``; FLOPs and the collective count are
  above zero on both sides (the other memory fields and the FLOPs are
  printed beside JAX's, not held: JAX counts a scan body once and fuses).
- ``corrected_cost``: the direct count equals ``base + sum (L_seg - 1)
  delta`` for qwen3-4b (one segment), deepseek-v2-lite-16b (dense + MoE)
  and seamless-m4t-large-v2 (encoder + decoder).
- A (2, 2, 2) ``("pod", "data", "model")`` cell, ``run_cell``'s record
  (every key ``benchmarks/roofline.py`` reads, JAX's skip text for
  ``long_500k``), and the process group: the dry-run refuses an open
  one and leaves none open after a cell that failed.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.launch import hlo_stats as jax_hlo
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.parallel.collectives import Collective

ROOT = Path(__file__).resolve().parents[1]
MINI = (2, 4)
KINDS = ("train", "prefill", "decode")

# -- collective_stats against JAX's HLO scan ----------------------------------

_HLO = {"f32": torch.float32, "bf16": torch.bfloat16, "s32": torch.int32}


def _dims(shape):
    return ",".join(str(d) for d in shape)


def _case(kind, slots, dtype, shape):
    """(the port's record, JAX's HLO line) of one collective over a line
    of ``slots`` of an 8-device mesh; ``shape`` is the record's payload
    (an all-gather's output, a reduce-scatter's input)."""
    n = 1
    for d in shape:
        n *= d
    nbytes = n * torch.empty((), dtype=_HLO[dtype]).element_size()
    groups = f"replica_groups=[{8 // slots},{slots}]<=[8]"
    t = f"{dtype}[{_dims(shape)}]{{1,0}}"
    if kind == "all_gather":
        part = (shape[0] // slots,) + tuple(shape[1:])
        line = (f"%all-gather.1 = {t} all-gather({dtype}[{_dims(part)}]"
                f"{{1,0}} %x), channel_id=1, {groups}, dimensions={{0}}, "
                "use_global_device_ids=true")
    elif kind == "reduce_scatter":
        part = (shape[0] // slots,) + tuple(shape[1:])
        line = (f"%reduce-scatter.1 = {dtype}[{_dims(part)}]{{1,0}} "
                f"reduce-scatter({t} %x), channel_id=2, {groups}, "
                "dimensions={0}, to_apply=%add")
    elif kind == "send":
        pairs = ",".join(f"{{{i},{(i + 1) % slots}}}" for i in range(slots))
        line = (f"%collective-permute.1 = {t} collective-permute({t} %x), "
                f"channel_id=3, source_target_pairs={{{pairs}}}")
    else:
        op = {"all_reduce": "all-reduce", "all_to_all": "all-to-all"}[kind]
        line = (f"%{op}.1 = {t} {op}({t} %x), channel_id=4, {groups}"
                + (", to_apply=%add" if kind == "all_reduce"
                   else ", dimensions={0}"))
    return Collective(kind, "model", nbytes, slots, tuple(shape)), "  " + line


_SHAPES = {2: ("f32", (64, 48)), 4: ("bf16", (96, 40)), 8: ("s32", (8, 24))}
_KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "send")


@pytest.mark.parametrize("kind", _KINDS + ("every_kind",))
def test_collective_stats_equals_jax(kind):
    kinds = _KINDS if kind == "every_kind" else (kind,)
    cases = [_case(k, slots, *_SHAPES[slots]) for slots in (2, 4, 8)
             for k in kinds]
    records = [c for c, _ in cases]
    hlo = "\n".join(["HloModule m", "ENTRY %main {"]
                    + [line for _, line in cases] + ["}"])
    want = jax_hlo.collective_stats(hlo)
    assert want["_total"]["count"] == len(cases)
    assert hlo_stats.collective_stats(records) == want


def test_collective_stats_broadcast_and_empty():
    rec = Collective("broadcast", "data", 4096, 4, (1024,))
    got = hlo_stats.collective_stats([rec, rec])
    assert got["broadcast"] == {"count": 2, "payload_bytes": 8192.0,
                                "link_bytes": 2 * rec.link_bytes}
    assert got["_total"]["count"] == 2
    assert hlo_stats.collective_stats([]) == jax_hlo.collective_stats("")


def test_count_ops_and_bytes():
    a, b = torch.ones(4, 8), torch.ones(8, 2)
    x = torch.ones(1, 2, 16)
    w = torch.ones(2, 1, 3)
    with hlo_stats.OpLog() as log:
        y = (a @ b).view(8)            # mm; a view: no work
        z = torch.relu(y) + 1          # two ops
        torch.nn.functional.conv1d(x, w, groups=2)
        z.detach()
    got = hlo_stats.count_ops(log.ops, 3)
    assert got == {"fusion": 2, "custom-call": 3, "while": 0, "dot": 1,
                   "convolution": 1}
    assert list(got) == ["fusion", "custom-call", "while", "dot",
                         "convolution"]
    # mm 128 + 64 in, 32 out; relu and add 32 + 32 each (the scalar is
    # no tensor); conv1d (32 + 6) * 4 in, 28 * 4 out
    assert log.bytes == 224 + 2 * 64 + (32 + 6 + 28) * 4
    assert hlo_stats.kernel_launches() == 0


# -- JAX's compiled mini cells, started with the file's first test -----------

_JAX_MINI = """
import json
from repro.configs import get_config
from repro.configs.shapes import InputShape
from repro.launch.hlo_stats import collective_stats
from repro.launch.mesh import make_debug_mesh
from repro.launch.steps import (shard_prefill_step, shard_serve_step,
                                shard_train_step)
mesh = make_debug_mesh((2, 4), ("data", "model"))
cfg = get_config("granite-moe-3b-a800m", smoke=True, kernel_mode="ref")
out = {}
for kind, fn in (("train", shard_train_step), ("prefill", shard_prefill_step),
                 ("decode", shard_serve_step)):
    with mesh:
        jitted, args = fn(cfg, mesh, InputShape("t", 32, 8, kind))
        c = jitted.lower(*args).compile()
        m, cost = c.memory_analysis(), c.cost_analysis()
        out[kind] = {
            "argument_bytes": int(m.argument_size_in_bytes),
            "output_bytes": int(m.output_size_in_bytes),
            "temp_bytes": int(m.temp_size_in_bytes),
            "alias_bytes": int(m.alias_size_in_bytes),
            "flops": float(cost["flops"]),
            "collectives": collective_stats(c.as_text())["_total"]}
# imported last: the module forces 512 host devices at import
from repro.configs import SHAPES
from repro.launch.dryrun import cell_should_run, skip_reason
out["skip"] = {a: [cell_should_run(a, SHAPES["long_500k"]),
                   skip_reason(a, SHAPES["long_500k"])]
               for a in ("qwen3-4b", "rwkv6-1.6b")}
print("JSON" + json.dumps(out))
"""


class _JaxMini:
    """JAX's compile of the mini cells, in a subprocess started at once
    and read at first use, so the port's cells run meanwhile."""

    def __init__(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=str(ROOT / "src"))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_JAX_MINI)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._out = None

    def result(self):
        if self._out is None:
            out, err = self.proc.communicate(timeout=300)
            assert self.proc.returncode == 0, err[-3000:]
            line = next(ln for ln in out.splitlines()
                        if ln.startswith("JSON"))
            self._out = json.loads(line[4:])
        return self._out

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


@pytest.fixture(scope="module", autouse=True)
def jax_mini():
    mini = _JaxMini()
    try:
        yield mini
    finally:
        mini.close()


# -- corrected_cost and the pod mesh --------------------------------------------


@pytest.mark.parametrize("arch,kind,overrides", [
    ("qwen3-4b", "train", {"n_layers": 3}),
    ("deepseek-v2-lite-16b", "decode", {"n_layers": 4}),
    ("seamless-m4t-large-v2", "prefill", {"n_enc_layers": 3,
                                          "n_layers": 3})])
def test_corrected_cost_is_linear_in_depth(arch, kind, overrides):
    cfg = get_config(arch, smoke=True, kernel_mode="ref", **overrides)
    with dryrun.fake_ranks(MINI, 5) as mesh:
        cc = dryrun.corrected_cost(cfg, InputShape("t", 32, 8, kind), mesh)
    assert cc["segment_counts"] == dryrun.segment_counts(cfg)
    assert max(cc["segment_counts"]) >= 3
    assert len(cc["per_segment_delta"]) == len(cc["segment_counts"])
    for k in ("flops", "bytes", "link_bytes", "coll_payload"):
        pred = cc["base"][k] + sum(
            (n - 1) * d[k] for n, d in zip(cc["segment_counts"],
                                           cc["per_segment_delta"]))
        # the serve step gathers each segment's cache lengths (count, B)
        # along B: at one layer ``.contiguous()`` copies nothing, at two
        # and more it copies, so decode's unfused bytes bend by that copy
        # (32 of 2.6e6 bytes here, 1e-8 of the bytes at full depth)
        rel = 1e-4 if (k, kind) == ("bytes", "decode") else 1e-12
        assert cc["total"][k] == pytest.approx(pred, rel=rel), k
        assert all(d[k] >= 0 for d in cc["per_segment_delta"])
    assert cc["total"]["flops"] > cc["base"]["flops"] > 0


def test_pod_mesh_cell():
    cfg = get_config("qwen3-4b", smoke=True, kernel_mode="ref")
    rec = dryrun.measure_cell({}, cfg, InputShape("t", 32, 8, "train"),
                              (2, 2, 2), rank=6)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 8
    assert rec["collectives"]["_total"]["count"] > 0
    assert rec["collectives"]["all-reduce"]["link_bytes"] > 0
    assert rec["cost_corrected"]["total"]["link_bytes"] > 0


# -- the process group ---------------------------------------------------------


def test_refuses_an_open_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = get_config("qwen3-4b", smoke=True, kernel_mode="ref")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="already"):
            dryrun.measure_cell({}, cfg, InputShape("t", 32, 8, "decode"),
                                MINI)
        with pytest.raises(RuntimeError, match="already"):
            with dryrun.fake_ranks(MINI):
                pass
    finally:
        dist.destroy_process_group()


def test_failed_cell_leaves_no_group():
    cfg = get_config("qwen3-4b", smoke=True, kernel_mode="ref")
    # a batch of 3 does not divide over 2 data slots: the train step refuses
    rec = dryrun.measure_cell({}, cfg, InputShape("t", 32, 3, "train"), MINI)
    assert rec["status"] == "error"
    assert "does not divide" in rec["error"]
    assert "Traceback" in rec["traceback"]
    assert not dist.is_initialized()


def test_import_opens_no_group_and_sets_no_variable():
    code = textwrap.dedent("""
        import os, sys
        before = dict(os.environ)
        import torch.distributed as dist
        import repro_torch.launch.dryrun, repro_torch.launch.hlo_stats
        assert dict(os.environ) == before
        assert not dist.is_initialized()
        assert not any(m.split(".")[0] in ("jax", "repro")
                       for m in sys.modules)
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", code],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr


# -- the mini mesh against JAX's compiled steps; run_cell's record -------------


@pytest.mark.parametrize("rank", range(8))
@pytest.mark.parametrize("kind", KINDS)
def test_mini_mesh_argument_bytes_equal_jax(jax_mini, kind, rank):
    cfg = get_config("granite-moe-3b-a800m", smoke=True, kernel_mode="ref")
    with dryrun.fake_ranks(MINI, rank) as mesh:
        assert mesh.coords == (rank // 4, rank % 4)
        got = dryrun.dry_run(cfg, InputShape("t", 32, 8, kind), mesh)
    want = jax_mini.result()[kind]
    print(kind, rank, {k: (got["memory"][k], want[k]) for k in
                       ("argument_bytes", "output_bytes", "temp_bytes",
                        "alias_bytes")},
          "flops", got["cost"]["flops"], want["flops"])
    assert got["memory"]["argument_bytes"] == want["argument_bytes"]
    assert got["cost"]["flops"] > 0 and want["flops"] > 0
    assert got["collectives"]["_total"]["count"] > 0
    assert want["collectives"]["count"] > 0
    assert got["n_devices"] == 8
    assert got["op_counts"]["dot"] > 0
    assert got["op_counts"]["custom-call"] == 0
    assert not dist.is_initialized()


def test_run_cell_record_and_skip(tmp_path, jax_mini):
    rec = dryrun.run_cell("qwen3-4b", "decode_32k", "single",
                          out_dir=tmp_path, overrides={"n_layers": 1},
                          variant="l1")
    assert rec["status"] == "ok", rec.get("traceback")
    path = tmp_path / "qwen3-4b__decode_32k__single__l1.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    # every key benchmarks/roofline.py reads
    for k in ("flops", "bytes", "link_bytes"):
        assert rec["cost_corrected"]["total"][k] > 0
    for k in ("argument_bytes", "temp_bytes", "output_bytes"):
        assert rec["memory"][k] > 0
    assert rec["n_devices"] == 256
    assert (rec["arch"], rec["kind"], rec["seq_len"],
            rec["global_batch"]) == ("qwen3-4b", "decode", 32768, 128)
    assert rec["memory"]["alias_bytes"] > 0     # the cache, in place
    assert rec["memory"]["code_bytes"] == 0
    # a second call reads the record back
    assert dryrun.run_cell("qwen3-4b", "decode_32k", "single",
                           out_dir=tmp_path, overrides={"n_layers": 1},
                           variant="l1") == json.loads(path.read_text())

    skip = jax_mini.result()["skip"]
    for arch in ("qwen3-4b", "rwkv6-1.6b"):
        from repro_torch.configs import SHAPES
        assert dryrun.cell_should_run(arch, SHAPES["long_500k"]) == \
            skip[arch][0]
    rec = dryrun.run_cell("qwen3-4b", "long_500k", "multi",
                          out_dir=tmp_path)
    assert rec["status"] == "skipped"
    assert rec["reason"] == skip["qwen3-4b"][1]
