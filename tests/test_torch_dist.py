"""One serving engine over several ranks (``torch.distributed``, gloo
on the CPU) against the JAX package, and the device guard of every
kernel launch.

- Every CUDA wrapper launches through ``kernels.common.launch``, which
  makes its operands' card current: read from the wrappers' source and
  held to the C entry points that take a stream.
- Rank meshes (``launch/mesh.py``): no process group, no rank mesh; a
  world of one in this process, where ``ShardedPagedServeLoop`` gathers
  its one-shard pool (a copy) and stays bit-identical to
  ``PagedServeLoop``.
- Eight ranks from ``repro_torch.launch.spawn``, one spawn for the
  file, every case in it (``tests/torch_rank_cases.py``; the ranks load
  no JAX): the collectives and the rank ``MeshChannel``, and
  ``tests/test_sharded_serve.py``'s serving cases on rank meshes.  Each
  rank's streams must equal JAX's ``PagedServeLoop``'s; the ten counters
  must be equal on every rank and equal to JAX's (co-located) or to the
  port's one-process loop on eight logical devices (disaggregated, where
  migrations and staging pages count too).  The cases: co-located with
  the default odd pool (replicated) and with ``n_pages=32`` (8 shards
  of 4 pages), the latter with a prompt that extends an earlier one
  (copy-on-write across shards); 4 + 4 disaggregated for qwen3-4b,
  granite-moe-3b-a800m and minicpm3-4b (6 migrations each); 3 slots, so
  that both pools shard (16 pages over 4 ranks); and ``n_pages=13``,
  where slots preempt themselves and resume.

Smoke configs, s_max 40-48, page 8, chunk 16.
"""

import ast
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_rank_cases as rc
from repro.configs import get_config as jax_get_config
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serve_loop import PagedServeLoop as JaxPagedServeLoop
from repro.runtime.serve_loop import Request as JaxRequest
from repro_torch.channels import LocalChannel, MeshChannel
from repro_torch.configs import get_config
from repro_torch.kernels import common
from repro_torch.launch.mesh import (RankMesh, make_debug_mesh,
                                     make_serve_meshes)
from repro_torch.launch.spawn import spawn
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.runtime.mesh_serve import ShardedPagedServeLoop
from repro_torch.runtime.serve_loop import PagedServeLoop, Request

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
CPU = torch.device("cpu")
WORLD = 8
ARCHS = ("qwen3-4b", "granite-moe-3b-a800m", "minicpm3-4b")
COLO = dict(batch_slots=4, s_max=48, chunk=16, page=8)
DISAGG = dict(batch_slots=8, s_max=40, chunk=16, page=8)
CASES = {
    "colocated_replicated": dict(arch="qwen3-4b", disaggregate=False,
                                 kw=COLO, reqs=((12, 3, 25, 7), 6, 11)),
    "colocated_sharded": dict(arch="qwen3-4b", disaggregate=False,
                              kw=dict(COLO, n_pages=32),
                              reqs=((12, 3, 25, 7), 6, 11)),
    "colocated_sharded_prefix": dict(arch="qwen3-4b", disaggregate=False,
                                     kw=dict(COLO, n_pages=32),
                                     reqs=((12, 3, 25, 7, 15), 6, 11)),
    **{f"disaggregated_{a}": dict(arch=a, disaggregate=True, kw=DISAGG,
                                  reqs=((12, 3, 25, 7, 1, 18), 6, 7))
       for a in ARCHS},
    "disaggregated_both_pools_sharded": dict(
        arch="qwen3-4b", disaggregate=True,
        kw=dict(DISAGG, batch_slots=3), reqs=((12, 3, 25, 7, 1, 18), 6, 7)),
    "disaggregated_preemption": dict(
        arch="qwen3-4b", disaggregate=True,
        kw=dict(batch_slots=4, s_max=40, chunk=16, page=8, n_pages=13),
        reqs=((30, 28, 26, 24, 22, 20), 8, 3)),
}
_MODELS = {}


def _weights(arch):
    """JAX's smoke model, its weights as numpy, and the port's model."""
    if arch not in _MODELS:
        jcfg = jax_get_config(arch, smoke=True)
        jb = jax_build_model(jcfg)
        jparams = jb.init(jax.random.PRNGKey(0))
        weights = jax.tree.map(np.asarray, jparams)
        cfg = get_config(arch, smoke=True)
        _MODELS[arch] = (jcfg, jb, jparams, weights, cfg,
                         build_model(cfg, device="cpu"),
                         params_from_numpy(cfg, weights, device="cpu"))
    return _MODELS[arch]


def _requests(cls, vocab, sizes, max_new, seed):
    """``torch_rank_cases.requests``; a fifth prompt of 15 tokens
    extends the first prompt (12 tokens) by three, so that its prefix
    is reused and its first write lands inside a shared page."""
    reqs = rc.requests(cls, vocab, sizes, max_new, seed)
    if len(sizes) == 5 and sizes[-1] == 15:
        reqs[-1] = cls(rid=4, prompt=np.concatenate(
            [reqs[0].prompt, reqs[-1].prompt[:3]]), max_new=max_new)
    return reqs


def _rank_requests(cases):
    """The cases' requests as the ranks build them (prompts pinned)."""
    out = {}
    for name, case in cases.items():
        vocab = get_config(case["arch"], smoke=True).vocab
        out[name] = [(r.prompt, r.max_new)
                     for r in _requests(Request, vocab, *case["reqs"])]
    return out


# -- the device guard ---------------------------------------------------------


def _stream_entries():
    """The C entry points that take a stream (``void* stream``)."""
    names = set()
    for path in (PKG / "csrc").glob("*.cu*"):
        for m in re.finditer(r'extern "C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
                             path.read_text(), re.S):
            if re.search(r"void\s*\*\s*stream\b", m.group(2)):
                names.add(m.group(1))
    return names


def _wrapper_calls():
    """Per kernel module: the entry points launched through
    ``launch(lib.<name>, ...)`` and every other ``lib.<name>(...)``
    call's name and whether an argument reads a stream."""
    launched, direct = {}, []
    for path in sorted((PKG / "kernels").glob("*/kernel.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and f.id == "launch":
                entry = node.args[0]
                assert isinstance(entry, ast.Attribute), ast.dump(node)
                launched[entry.attr] = path.parent.name
            elif (isinstance(f, ast.Attribute)
                  and isinstance(f.value, ast.Name) and f.value.id == "lib"):
                src = ast.unparse(node)
                direct.append((path.parent.name, f.attr,
                               "stream" in src or "cuda_stream" in src))
    return launched, direct


def test_every_kernel_launch_goes_through_the_device_guard():
    launched, direct = _wrapper_calls()
    entries = _stream_entries()
    assert len(entries) == 12
    assert set(launched) == entries
    assert not [d for d in direct if d[2] or d[1] in entries]
    # the stream is read in one place: the launch itself (and the
    # decodes' per-stream counter buffers, which launch nothing)
    uses = {p.parent.name: p.read_text().count("stream_ptr(")
            for p in (PKG / "kernels").glob("*/kernel.py")}
    assert uses == {**{k: 0 for k in uses}, "flash_attention": 1}


def test_launch_makes_the_device_current(monkeypatch):
    seen = []

    class Current:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            seen.append(("enter", self.dev))

        def __exit__(self, *exc):
            seen.append(("exit", self.dev))

    monkeypatch.setattr(common.torch.cuda, "device", Current)
    monkeypatch.setattr(common, "stream_ptr", lambda dev: 1000 + dev.index)
    dev = torch.device("cuda", 1)

    def entry(*args):
        seen.append(("call", args))
        return 0

    assert common.launch(entry, dev, 7, 8) == 0
    assert seen == [("enter", dev), ("call", (7, 8, 1001)), ("exit", dev)]


# -- rank meshes in this process ----------------------------------------------


def test_a_rank_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    for build in (lambda: make_serve_meshes(1, ranks=True),
                  lambda: make_debug_mesh((1,), ("data",), ranks=True),
                  lambda: RankMesh(np.zeros(1, int), ("data",))):
        with pytest.raises(RuntimeError, match="process group"):
            build()
    with pytest.raises(ValueError, match="not both"):
        make_serve_meshes(1, devices=[CPU], ranks=True)


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_rank_mesh_validation_in_a_world_of_one(world_of_one):
    with pytest.raises(RuntimeError) as e:
        make_serve_meshes(2, ranks=True)
    assert "need 2 devices" in str(e.value) and "have 1" in str(e.value)
    with pytest.raises(RuntimeError, match="need 8 devices"):
        make_debug_mesh((2, 4), ("data", "model"), ranks=True)
    meshes = make_serve_meshes(ranks=True)
    assert not meshes.disaggregated
    assert meshes.decode.shape == {"data": 1} and meshes.decode.member
    assert meshes.decode.coords == (0,)
    assert meshes.decode.physical_devices() == [CPU]
    with pytest.raises(ValueError, match="distinct"):
        RankMesh([0, 0], ("data",))


@pytest.mark.parametrize("arch", ARCHS)
def test_world_of_one_is_bit_identical_to_paged(world_of_one, arch):
    """One rank: the pool shards one way, so every layer gathers it (a
    copy) and keeps it back; streams, the ten counters and the traced
    channel depths equal ``PagedServeLoop``'s."""
    *_, cfg, bundle, params = _weights(arch)
    kw = dict(batch_slots=3, s_max=40, chunk=16, page=8)
    reqs = lambda: _requests(Request, cfg.vocab, (12, 3, 25, 7, 15),   # noqa
                             5, 7)
    base = PagedServeLoop(cfg, bundle, params, **kw)
    want = base.run(reqs())
    loop = ShardedPagedServeLoop(cfg, bundle, params,
                                 meshes=make_serve_meshes(ranks=True), **kw)
    assert loop.run(reqs()) == want
    for k in rc.SERVE_STATS:
        assert getattr(loop.stats, k) == getattr(base.stats, k), k
    assert loop._split == {"access": False, "execute": True}
    assert loop.cfg.mesh_pool_axis == "data"
    assert loop.bundle.cfg.mesh_pool_axis == "data"
    assert isinstance(loop.handoff, MeshChannel) and loop.handoff.span == 1
    if arch == "qwen3-4b":
        assert base.stats.cow_copies > 0     # the sharded copy-on-write


# -- eight ranks ----------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks():
    """Every case of this file on 8 gloo ranks, in one spawn."""
    weights = {a: _weights(a)[3] for a in ARCHS}
    return spawn(rc.dist_cases, WORLD, weights, CASES,
                 _rank_requests(CASES), timeout=600)


def test_spawned_ranks_load_no_jax(ranks):
    assert len(ranks) == WORLD
    assert not any(r["collectives"]["jax_loaded"] or r["serve"]["jax_loaded"]
                   for r in ranks)


def test_collectives_on_a_2x4_mesh(ranks):
    out = [r["collectives"]["cases"] for r in ranks]
    for r, o in enumerate(out):
        d, m = divmod(r, 4)
        assert o["coords"] == (d, m)
        line = list(range(4 * d, 4 * d + 4))
        assert list(o["model_line"]) == line
        assert list(o["data_line"]) == [m, m + 4]
        assert o["psum_model"] == [float(sum(line)),
                                   sum(10.0 * i + 1 for i in line)]
        assert o["pmax_data"] == [float(m + 4), 10.0 * (m + 4) + 1]
        assert o["psum_all"] == [28.0, 10.0 * 28 + 8]
        assert o["gather_model"] == [[float(i), 10.0 * i + 1] for i in line]
        assert o["gather_dim1"] == [[float(m), float(m + 4)],
                                    [10.0 * m + 1, 10.0 * (m + 4) + 1]]
        assert o["a2a_model"] == [100 * i + m for i in line]
        prev = line[(m - 1) % 4]
        assert o["ring_model"] == [float(prev), 10.0 * prev + 1]
        assert o["one_pair"] == ([float(line[1]), 10.0 * line[1] + 1]
                                 if m == 3 else [0.0, 0.0])
        assert o["bcast_data"] == [float(m + 4), 10.0 * (m + 4) + 1]
        assert o["bcast_all"] == [5.0, 51.0]
        assert o["bf16_gather"] == [i + 0.5 for i in range(8)
                                    for _ in range(2)]
        assert o["int_psum"] == [28]
        assert o["four_member"] == (r < 4)
        # (4, 4) over (data 2, model 4): rows 2d, 2d + 1 of column m
        assert o["place"] == ([[8.0 * d + m], [8.0 * d + 4 + m]], 8, True,
                              r >= 4)


def test_rank_mesh_channels_match_local(ranks):
    want = []
    ch = LocalChannel("ch", 3)
    for op in ("push5", "push39", "pop", "pushbig", "push7", "push8",
               "peek", "pop", "pop", "pop", "len"):
        if op.startswith("push"):
            item = {"push5": 5, "push39": (3, 9), "pushbig": (-1, 2 ** 30),
                    "push7": 7, "push8": 8}[op]
            want.append(ch.push(item))
        elif op == "len":
            want.append(len(ch))
        else:
            got = getattr(ch, op)()
            want.append(list(got) if isinstance(got, tuple) else got)
    for r in ranks:
        trace = r["collectives"]["cases"]["channels"]
        assert trace["role"] == want and trace["data"] == want


def _jax_case(name):
    case = CASES[name]
    jcfg, jb, jparams, *_ = _weights(case["arch"])
    kw = dict(case["kw"])
    if case["disaggregate"]:
        kw["prefix_reuse"] = False
    loop = JaxPagedServeLoop(jcfg, jb, jparams, **kw)
    streams = loop.run(_requests(JaxRequest, jcfg.vocab, *case["reqs"]))
    return streams, {k: getattr(loop.stats, k) for k in rc.SERVE_STATS}


def _one_process(name):
    """The same case on eight logical devices of this process."""
    case = CASES[name]
    *_, cfg, bundle, params = _weights(case["arch"])
    loop = ShardedPagedServeLoop(
        cfg, bundle, params, meshes=make_serve_meshes(
            WORLD, disaggregate=case["disaggregate"], devices=[CPU] * WORLD),
        **case["kw"])
    loop.run(_requests(Request, cfg.vocab, *case["reqs"]))
    return loop


@pytest.mark.parametrize("name", sorted(CASES))
def test_serving_over_eight_ranks_matches_jax(ranks, name):
    case = CASES[name]
    got = [r["serve"]["cases"][name] for r in ranks]
    streams, jax_stats = _jax_case(name)
    for r, g in enumerate(got):
        assert g["streams"] == streams, r
        assert g["stats"] == got[0]["stats"], r
        assert g["migrations"] == got[0]["migrations"], r
        assert g["mesh_pool_axis"] == "data"
    stats = got[0]["stats"]
    if case["disaggregate"]:
        local = _one_process(name)
        assert stats == {k: getattr(local.stats, k) for k in rc.SERVE_STATS}
        assert [m[:2] for m in got[0]["migrations"]] == \
            [(m.slot, m.pages) for m in local.migration_log]
        assert [m[2] for m in got[0]["migrations"]] == \
            [m.bytes for m in local.migration_log]
        assert got[0]["handoff"] == ("role", 2)
    else:
        assert stats == jax_stats
        assert got[0]["handoff"] == ("data", WORLD)


def _holds(name, rank):
    return [r["serve"]["cases"][name] for r in rank]


def test_the_pool_shards_only_where_data_divides_it(ranks):
    """``cache_shardings``' rule on rank meshes: 25 pages over 8 ranks
    stay whole on each, 32 split 4 a rank; disaggregated (4 + 4), the
    41-page staging and decode pools stay whole, 16 pages split 4 a
    rank, and a rank holds only its engine's pool."""
    for g in _holds("colocated_replicated", ranks):
        assert g["split"] == {"access": False, "execute": False}
        assert g["pool_pages"] == 25
    for g in _holds("colocated_sharded", ranks):
        assert g["split"] == {"access": False, "execute": True}
        assert g["pool_pages"] == 4
    for r, g in enumerate(_holds("disaggregated_qwen3-4b", ranks)):
        assert g["split"] == {"access": False, "execute": False}
        assert (g["staging_pages"], g["pool_pages"]) == \
            ((41, None) if r < 4 else (None, 41))
    for r, g in enumerate(_holds("disaggregated_both_pools_sharded", ranks)):
        assert g["split"] == {"access": True, "execute": True}
        assert (g["staging_pages"], g["pool_pages"]) == \
            ((4, None) if r < 4 else (None, 4))


def test_eight_rank_cases_move_what_they_should(ranks):
    colo = _holds("colocated_sharded_prefix", ranks)[0]["stats"]
    assert colo["prefix_hits"] > 0 and colo["cow_copies"] > 0
    for arch in ARCHS:
        got = _holds(f"disaggregated_{arch}", ranks)[0]
        assert got["stats"]["migrations"] == 6
        assert sorted(m[1] for m in got["migrations"]) == \
            sorted(-(-n // 8) for n in (12, 3, 25, 7, 1, 18))
    pre = _holds("disaggregated_preemption", ranks)[0]["stats"]
    assert pre["preemptions"] > 0 and pre["migrations"] >= 6
