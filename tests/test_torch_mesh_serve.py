"""The port's ``ShardedPagedServeLoop`` (``runtime/mesh_serve.py``) on
the CPU, with the cases of ``tests/test_sharded_serve.py`` on logical
devices (``devices=[torch.device("cpu")] * n`` where JAX's tests force 8
host devices):

- one slot, co-located: bit-identical to the port's ``PagedServeLoop``
  (streams, the ten counters, the channels' traced depths) for one model
  per attention family, the recurrent fallback included;
- disaggregated over 8 slots: streams equal to JAX's
  ``PagedServeLoop(prefix_reuse=False)`` on the same converted weights,
  one migration per completed prefill, each moving only the slot's real
  pages;
- disaggregated under page-pool pressure: slots preempt themselves and
  resume teacher-forced with the same streams;
- co-located over 8 slots: the rings span the axis (the pool's specs
  at this shape are held to JAX's in ``test_torch_mesh.py``);
- an engine mesh over two physical devices in one process raises (it
  runs on a rank mesh, ``tests/test_torch_dist.py``), and prefill and
  decode engines on two different physical devices no longer do.

Smoke configs, s_max 40-48, page 8, chunk 16.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serve_loop import PagedServeLoop as JaxPagedServeLoop
from repro.runtime.serve_loop import Request as JaxRequest
from repro_torch.channels import LocalChannel, MeshChannel
from repro_torch.configs import get_config
from repro_torch.core.trace import Tracer
from repro_torch.launch.mesh import Mesh, make_serve_meshes
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.runtime.mesh_serve import ShardedPagedServeLoop
from repro_torch.runtime.serve_loop import PagedServeLoop, Request

CPU = torch.device("cpu")
FAMILIES = ("qwen3-4b", "granite-moe-3b-a800m", "minicpm3-4b",
            "rwkv6-1.6b")
PAGED = FAMILIES[:3]
_STATS = ("prefill_steps", "decode_steps", "prefill_tokens",
          "decode_tokens", "admitted", "page_allocs", "cow_copies",
          "preemptions", "prefix_hits", "migrations")
_CACHE = {}


def _models(arch):
    """JAX's smoke model and the port's, holding JAX's weights."""
    if arch not in _CACHE:
        jcfg = jax_get_config(arch, smoke=True)
        jb = jax_build_model(jcfg)
        jparams = jb.init(jax.random.PRNGKey(0))
        cfg = get_config(arch, smoke=True)
        params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
        _CACHE[arch] = (jcfg, jb, jparams, cfg,
                        build_model(cfg, device="cpu"), params)
    return _CACHE[arch]


def _requests(vocab, sizes, max_new, seed, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=n),
                max_new=max_new) for i, n in enumerate(sizes)]


def _jax_streams(arch, sizes, max_new, seed, **kw):
    jcfg, jb, jparams, *_ = _models(arch)
    loop = JaxPagedServeLoop(jcfg, jb, jparams, **kw)
    return loop.run(_requests(jcfg.vocab, sizes, max_new, seed, JaxRequest))


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh1_bit_parity(arch):
    *_, cfg, bundle, params = _models(arch)
    kw = dict(batch_slots=3, s_max=40, chunk=16, page=8)
    reqs = lambda: _requests(cfg.vocab, (12, 3, 25, 7), 5, 7)   # noqa: E731
    tracers = Tracer(), Tracer()
    base = PagedServeLoop(cfg, bundle, params, tracer=tracers[0], **kw)
    r0 = base.run(reqs())
    loop = ShardedPagedServeLoop(cfg, bundle, params, tracer=tracers[1],
                                 meshes=make_serve_meshes(1, devices=[CPU]),
                                 **kw)
    r1 = loop.run(reqs())
    assert r0 == r1
    for k in _STATS:
        assert getattr(base.stats, k) == getattr(loop.stats, k), k
    assert loop.stats.migrations == 0
    assert tracers[0].summary().channel_occupancy() == \
        tracers[1].summary().channel_occupancy()
    assert isinstance(base.handoff, LocalChannel)
    assert isinstance(loop.handoff, MeshChannel)
    assert loop.handoff.span == loop.free_slots.span == 1
    assert loop.paged == (arch != "rwkv6-1.6b")
    if loop.paged:
        assert loop.params is params          # one device: nothing copied


def test_default_meshes_are_the_bundle_device():
    *_, cfg, bundle, params = _models("qwen3-4b")
    loop = ShardedPagedServeLoop(cfg, bundle, params, batch_slots=2,
                                 s_max=40, page=8)
    assert not loop.meshes.disaggregated
    assert loop.meshes.decode.physical_devices() == [CPU]


@pytest.mark.parametrize("arch", PAGED)
def test_disaggregated_output_parity_8dev(arch):
    *_, cfg, bundle, params = _models(arch)
    sizes, kw = (12, 3, 25, 7, 1, 18), dict(batch_slots=8, s_max=40,
                                            chunk=16, page=8)
    want = _jax_streams(arch, sizes, 6, 7, prefix_reuse=False, **kw)
    meshes = make_serve_meshes(8, devices=[CPU] * 8)
    assert meshes.disaggregated
    loop = ShardedPagedServeLoop(cfg, bundle, params, meshes=meshes, **kw)
    assert loop.run(_requests(cfg.vocab, sizes, 6, 7)) == want
    assert loop.stats.migrations == 6       # one per completed prefill
    assert loop.prefix is None              # forced off
    assert loop.n_pages_pf == 1 + 8 * loop.npb
    assert loop.alloc_pf.free_count == loop.n_pages_pf - 1   # all released
    # each migration moves the slot's real pages only, none padded
    per_page = sum(v[:, :1].numel() * v.element_size()
                   for seg in loop.cache for k, v in seg["attn"].items()
                   if k != "len")
    assert sorted(m.pages for m in loop.migration_log) == \
        sorted(-(-n // 8) for n in sizes)
    assert all(m.bytes == m.pages * per_page and m.seconds >= 0
               for m in loop.migration_log)
    assert isinstance(loop.handoff, MeshChannel)
    assert loop.handoff.axis == "role" and loop.handoff.span == 2


def test_disaggregated_preemption_resume_8dev():
    *_, cfg, bundle, params = _models("qwen3-4b")
    sizes = (30, 28, 26, 24, 22, 20)
    # n_pages=13: the decode pool holds barely over two horizons, so
    # migrations fail and slots preempt themselves and resume
    kw = dict(batch_slots=4, s_max=40, chunk=16, page=8, n_pages=13)
    want = _jax_streams("qwen3-4b", sizes, 8, 3, prefix_reuse=False, **kw)
    loop = ShardedPagedServeLoop(cfg, bundle, params,
                                 meshes=make_serve_meshes(8, devices=[CPU] * 8),
                                 **kw)
    assert loop.run(_requests(cfg.vocab, sizes, 8, 3)) == want
    assert loop.stats.preemptions > 0
    assert loop.stats.migrations >= len(sizes)
    assert loop.alloc_pf.free_count == loop.n_pages_pf - 1


@pytest.mark.parametrize("n_pages", (None, 32))
def test_colocated_mesh8_output_parity(n_pages):
    *_, cfg, bundle, params = _models("qwen3-4b")
    sizes = (12, 3, 25, 7)
    kw = dict(batch_slots=4, s_max=48, chunk=16, page=8, n_pages=n_pages)
    want = _jax_streams("qwen3-4b", sizes, 6, 11, **kw)
    meshes = make_serve_meshes(8, disaggregate=False, devices=[CPU] * 8)
    loop = ShardedPagedServeLoop(cfg, bundle, params, meshes=meshes, **kw)
    assert loop.run(_requests(cfg.vocab, sizes, 6, 11)) == want
    assert loop.handoff.span == 8            # ring spans the full axis
    assert (loop.handoff.src, loop.handoff.dst) == (0, 7)
    assert loop.cfg.mesh_pool_axis == "data"
    assert loop.stats.migrations == 0


def test_recurrent_disaggregated_keeps_the_contiguous_path():
    *_, cfg, bundle, params = _models("rwkv6-1.6b")
    kw = dict(batch_slots=4, s_max=40, chunk=16, page=8)
    reqs = lambda: _requests(cfg.vocab, (12, 3, 25, 7), 5, 7)   # noqa: E731
    want = PagedServeLoop(cfg, bundle, params, **kw).run(reqs())
    loop = ShardedPagedServeLoop(
        cfg, bundle, params, meshes=make_serve_meshes(4, devices=[CPU] * 4),
        **kw)
    assert loop.run(reqs()) == want
    assert not loop.paged and loop.stats.migrations == 0
    assert loop.handoff.axis == "role"


@pytest.mark.parametrize("disaggregate", (False, True))
def test_engine_mesh_over_two_physical_devices_raises(disaggregate):
    *_, cfg, bundle, params = _models("qwen3-4b")
    meta = torch.device("meta")
    devices = [CPU, meta] * (2 if disaggregate else 1)
    meshes = make_serve_meshes(len(devices), disaggregate=disaggregate,
                               devices=devices)
    with pytest.raises(NotImplementedError, match="collective"):
        ShardedPagedServeLoop(cfg, bundle, params, batch_slots=2, s_max=40,
                              page=8, meshes=meshes)


def test_engines_on_two_distinct_physical_devices_raise():
    """The loop no longer refuses engines on two physical devices (each
    engine's steps run with its device current; two cards run in
    ``tests/test_torch_gpu.py``): on ``[cpu, meta]`` it places the
    decode engine on the data-less meta device and gets as far as its
    first copy there, which torch itself refuses."""
    *_, cfg, bundle, params = _models("qwen3-4b")
    meshes = make_serve_meshes(2, devices=[CPU, torch.device("meta")])
    assert meshes.disaggregated
    assert meshes.prefill.physical_devices() != \
        meshes.decode.physical_devices()
    with pytest.raises(NotImplementedError, match="meta tensor"):
        ShardedPagedServeLoop(cfg, bundle, params, batch_slots=2, s_max=40,
                              page=8, meshes=meshes)


def test_disaggregated_engines_on_two_logical_slots_of_one_device():
    """chip_smoke.py's placement, [dev, dev]: a staging pool of its own
    on the prefill slot's device; the parameters are not copied."""
    *_, cfg, bundle, params = _models("qwen3-4b")
    meshes = make_serve_meshes(2, devices=[CPU, CPU])
    assert isinstance(meshes.union, Mesh) and meshes.disaggregated
    kw = dict(batch_slots=3, s_max=40, chunk=16, page=8)
    loop = ShardedPagedServeLoop(cfg, bundle, params, meshes=meshes, **kw)
    assert loop._params_pf is loop.params is params
    assert loop.cache_pf is not loop.cache
    assert loop.cache_pf[0]["attn"]["kp"].shape[1] == 1 + 3 * loop.npb
    want = PagedServeLoop(cfg, bundle, params, prefix_reuse=False,
                          **kw).run(_requests(cfg.vocab, (12, 3, 25), 5, 7))
    assert loop.run(_requests(cfg.vocab, (12, 3, 25), 5, 7)) == want
    assert loop.stats.migrations == 3
