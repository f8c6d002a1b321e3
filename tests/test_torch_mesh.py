"""The mesh layer of the port's sharded serving, against the JAX
package on the CPU: ``launch/mesh.py``'s meshes and their validation,
``channels/mesh.py``'s ``MeshChannel`` (the cases of
``tests/test_channels.py`` and a span-8 ring), ``parallel/sharding.py``'s
specs leaf for leaf against JAX's own functions (called on
``AbstractMesh`` in its jax 0.9 form), placement on an engine mesh's
device, ``lm_gather_pages``/``lm_scatter_pages`` bit-equal to JAX's, and
the config fields the mesh code reads.

The port's meshes are logical devices: ``[torch.device("cpu")] * n``
stands where JAX's tests force host devices.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.channels import MeshChannel as JaxMeshChannel
from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_serve_meshes as jax_make_serve_meshes
from repro.models import transformer as jax_t
from repro.models.common import ModelConfig as JaxModelConfig
from repro.models.registry import build_model as jax_build_model
from repro.parallel import sharding as jsh
from repro_torch.channels import ChannelBase, LocalChannel, MeshChannel
from repro_torch.configs import get_config
from repro_torch.core.trace import Tracer
from repro_torch.launch.mesh import (Mesh, make_debug_mesh,
                                     make_production_mesh, make_serve_meshes)
from repro_torch.models import transformer as t
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.parallel import sharding as sh

CPU = torch.device("cpu")
META = torch.device("meta")
FAMILIES = ("qwen3-4b", "granite-moe-3b-a800m", "minicpm3-4b",
            "rwkv6-1.6b")
PAGED = FAMILIES[:3]


class RecordingTracer(Tracer):
    def __init__(self):
        self.occ = []

    def on_occupancy(self, instance, channel, depth, t=0.0):
        self.occ.append((instance, channel, depth, t))


def _mesh1():
    return make_serve_meshes(1, devices=[CPU]).decode


def _make(transport, name="ch", capacity=3, tracer=None):
    if transport == "local":
        return LocalChannel(name, capacity, tracer)
    return MeshChannel(name, capacity, _mesh1(), "data", tracer=tracer)


# -- MeshChannel: tests/test_channels.py's cases ------------------------------


@pytest.mark.parametrize("transport", ("local", "mesh"))
def test_fifo_order_and_backpressure(transport):
    c = _make(transport, capacity=2)
    assert isinstance(c, ChannelBase)
    assert c.transport == transport
    assert len(c) == 0 and not c
    assert c.push(1) and c.push(2)
    assert c.full
    assert not c.push(3)           # refused, no side effects
    assert len(c) == 2
    assert c.peek() == 1
    assert c.pop() == 1 and c.pop() == 2
    assert not c.full and len(c) == 0


@pytest.mark.parametrize("transport", ("local", "mesh"))
def test_post_event_depth_trace(transport):
    tr = RecordingTracer()
    c = _make(transport, name="q", capacity=4, tracer=tr)
    c.push(10)
    c.push(11)
    c.pop()
    c.push(12)
    c.pop()
    c.pop()
    assert [d for (_, _, d, _) in tr.occ] == [1, 2, 1, 2, 1, 0]
    assert all(inst == "serve" and ch == "q" for (inst, ch, _, _) in tr.occ)


@pytest.mark.parametrize("transport", ("local", "mesh"))
def test_refused_push_does_not_trace(transport):
    tr = RecordingTracer()
    c = _make(transport, capacity=1, tracer=tr)
    c.push(1)
    assert not c.push(2)
    assert len(tr.occ) == 1


@pytest.mark.parametrize("op", ("pop", "peek"))
@pytest.mark.parametrize("transport", ("local", "mesh"))
def test_empty_raises(transport, op):
    with pytest.raises(IndexError):
        getattr(_make(transport), op)()


def test_mesh_ring_wraps_and_carries_tuples():
    c = MeshChannel("handoff", 3, _mesh1(), "data")
    assert c.push(5)
    assert c.push((7, 11))
    assert c.push(42)
    assert c.pop() == 5
    assert c.pop() == (7, 11)
    assert c.push(-3)              # tail wraps to ring slot 0
    assert c.pop() == 42
    assert c.pop() == -3
    assert len(c) == 0


def test_mesh_wire_format_rejections():
    c = MeshChannel("ctl", 2, _mesh1(), "data", width=2)
    with pytest.raises(TypeError):
        c.push("not-an-int")
    with pytest.raises(ValueError):
        c.push((1, 2, 3))          # arity exceeds width
    with pytest.raises(ValueError):
        c.push(2 ** 40)            # does not fit int32
    assert len(c) == 0


def test_mesh_requires_finite_capacity_and_known_axis():
    with pytest.raises(ValueError):
        MeshChannel("c", None, _mesh1(), "data")
    with pytest.raises(ValueError):
        MeshChannel("c", 0, _mesh1(), "data")
    with pytest.raises(ValueError):
        MeshChannel("c", 2, _mesh1(), "model")


def _ops(seed, n=200):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        r = rng.random()
        if r < 0.5:
            k = int(rng.integers(0, 3))
            yield ("push", int(rng.integers(-2 ** 31, 2 ** 31)) if k == 0
                   else tuple(int(v) for v in rng.integers(-9, 9, k)))
        else:
            yield ("pop" if r < 0.85 else "peek", None)


def _drive(c, ops):
    out = []
    for op, arg in ops:
        if op == "push":
            out.append(c.push(arg))
        else:
            try:
                out.append(getattr(c, op)())
            except IndexError:
                out.append("empty")
    return out


@pytest.mark.parametrize("seed", range(3))
def test_span1_mesh_channel_behaves_as_local_and_as_jax(seed):
    """One random sequence of pushes, pops and peeks through the port's
    LocalChannel, its span-1 MeshChannel and JAX's MeshChannel on one
    device: the same results and the same traced depths."""
    ops = list(_ops(seed))
    runs = []
    jm = jax_make_serve_meshes(1).decode
    for make in (lambda tr: LocalChannel("q", 4, tr),
                 lambda tr: MeshChannel("q", 4, _mesh1(), "data", tracer=tr),
                 lambda tr: JaxMeshChannel("q", 4, jm, "data", tracer=tr)):
        tr = RecordingTracer()
        runs.append((_drive(make(tr), ops), tr.occ))
    assert runs[0] == runs[1] == runs[2]
    assert any(r == "empty" for r in runs[0][0])
    assert any(r is False for r in runs[0][0])     # backpressure was hit


def test_span8_ring_lands_only_in_the_destination_row():
    mesh = make_serve_meshes(8, disaggregate=False,
                             devices=[CPU] * 8).decode
    c = MeshChannel("ring", 4, mesh, "data", src=0, dst=7, width=3)
    assert c.span == 8 and (c.src, c.dst) == (0, 7)
    assert len(c.rows) == 8
    assert all(r.device == CPU and tuple(r.shape) == (4, 3) for r in c.rows)
    assert c.push((5, -6, 7))
    assert c.rows[7][0].tolist() == [5, -6, 7]
    for i in range(7):
        assert not c.rows[i].any(), i
    assert c.peek() == (5, -6, 7) and c.pop() == (5, -6, 7)
    # default dst is the last slot, and negative indices wrap
    assert MeshChannel("r", 2, mesh, "data", src=-1).src == 7
    assert MeshChannel("r", 2, mesh, "data").dst == 7


def test_union_ring_crosses_the_role_axis():
    meshes = make_serve_meshes(4, devices=[CPU] * 4)
    c = MeshChannel("prefill_done", 2, meshes.union, "role", src=0, dst=1)
    assert c.span == 2
    c.push((3, 9))
    assert c.rows[1][0].tolist() == [3, 9] and not c.rows[0].any()
    assert c.pop() == (3, 9)


# -- launch/mesh.py: tests/test_sharded_serve.py's validation -----------------


def test_make_debug_mesh_actionable_error():
    with pytest.raises(RuntimeError) as e:
        make_debug_mesh((2, 4), ("data", "model"), devices=[CPU])
    msg = str(e.value)
    assert "need 8 devices" in msg and "have 1" in msg
    assert "devices=" in msg
    m = make_debug_mesh((2, 4), ("data", "model"), devices=[CPU] * 8)
    assert m.shape == {"data": 2, "model": 4} and m.size == 8
    assert m.physical_devices() == [CPU]


def test_make_serve_meshes_validation():
    meshes = make_serve_meshes(1, devices=[CPU])
    assert not meshes.disaggregated
    assert meshes.prefill is meshes.decode is meshes.union
    assert meshes.decode.shape == {"data": 1}
    with pytest.raises(ValueError):
        make_serve_meshes(0, devices=[CPU])
    with pytest.raises(RuntimeError) as e:
        make_serve_meshes(8, devices=[CPU])
    assert "need 8 devices" in str(e.value) and "have 1" in str(e.value)
    with pytest.raises(ValueError):
        make_serve_meshes(1, disaggregate=True, devices=[CPU])
    with pytest.raises(ValueError):
        make_serve_meshes(3, disaggregate=True, devices=[CPU] * 3)
    # n = 1 is co-located whatever disaggregate's default would say
    assert not make_serve_meshes(1, devices=[CPU] * 8).disaggregated


def test_make_serve_meshes_layout_matches_jax():
    m8 = make_serve_meshes(8, devices=[CPU] * 8)
    assert m8.disaggregated
    assert m8.union.shape == {"role": 2, "data": 4}
    assert m8.prefill.shape == m8.decode.shape == {"data": 4}
    assert not make_serve_meshes(8, disaggregate=False,
                                 devices=[CPU] * 8).disaggregated
    assert make_serve_meshes(devices=[CPU] * 6).union.shape == \
        {"role": 2, "data": 3}
    assert not make_serve_meshes(devices=[CPU] * 3).disaggregated
    j = jax_make_serve_meshes(1)
    mine = make_serve_meshes(1, devices=[CPU])
    assert (mine.axis, mine.role_axis) == (j.axis, j.role_axis)
    assert dict(j.decode.shape) == mine.decode.shape


def test_default_devices_are_the_visible_cards():
    if torch.cuda.is_available():
        pytest.skip("asserts the no-card error")
    with pytest.raises(RuntimeError) as e:
        make_serve_meshes()
    assert "have 0" in str(e.value) and "devices=" in str(e.value)


def test_production_mesh_shapes():
    m = make_production_mesh(devices=[CPU] * 256)
    assert m.shape == {"data": 16, "model": 16}
    m = make_production_mesh(multi_pod=True, devices=[CPU] * 512)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError):
        make_production_mesh(devices=[CPU] * 255)


# -- parallel/sharding.py against JAX's ---------------------------------------

MESHES = {"data8": ((8,), ("data",)),
          "data2_model4": ((2, 4), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}
RULES = (jsh.ShardingRules(), jsh.ShardingRules(fsdp=False,
                                                seq_shard_cache=False))


def _meshes(key):
    shape, axes = MESHES[key]
    jm = AbstractMesh(shape, axes)
    n = int(np.prod(shape))
    return jm, Mesh(np.array([CPU] * n, dtype=object).reshape(shape), axes)


def _rules(r):
    return sh.ShardingRules(fsdp=r.fsdp, seq_shard_cache=r.seq_shard_cache)


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        jcfg = jax_get_config(arch, smoke=True)
        jb = jax_build_model(jcfg)
        shapes = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0)))
        cfg = get_config(arch, smoke=True)
        bundle = build_model(cfg, device="cpu")
        params = bundle.init(torch.Generator().manual_seed(0))
        _MODELS[arch] = (jcfg, jb, shapes, cfg, bundle, params)
    return _MODELS[arch]


def _jax_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _spec(s):
    return tuple(s.spec)


@pytest.mark.parametrize("rules", range(len(RULES)))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_specs_match_jax(arch, mesh, rules):
    jcfg, jb, shapes, cfg, bundle, params = _models(arch)
    jm, pm = _meshes(mesh)
    want = jsh.param_shardings(shapes, jm, RULES[rules])
    got = sh.param_shardings(params, pm, _rules(RULES[rules]))
    from repro_torch.models.convert import reference_key
    assert set(got) == {n for n, _ in params.named_parameters()}
    leaves = set()
    for name, s in got.items():
        path, _ = reference_key(name)
        leaves.add(path)
        assert s.mesh is pm
        assert _spec(s) == _spec(_jax_leaf(want, path)), name
    assert len(leaves) == len(jax.tree.leaves(shapes))
    # the pure function, on one leaf at JAX's path and shape
    jpath = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for path, leaf in jpath:
        names = jsh._path_names(path)
        assert tuple(sh.param_pspec(names, leaf.shape, pm,
                                    _rules(RULES[rules]))) == \
            tuple(jsh.param_pspec(names, leaf.shape, jm, RULES[rules]))


def _jax_shapes(tree):
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        tree)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_specs_match_jax(arch, mesh):
    jcfg, jb, _, cfg, bundle, _ = _models(arch)
    jm, pm = _meshes(mesh)
    trees = [(bundle.cache_init(b, s), jax.eval_shape(
        lambda b=b, s=s: jb.cache_init(b, s)))
        for b, s in ((8, 40), (6, 48), (6, 44))]
    if bundle.cache_init_paged is not None:
        trees += [(bundle.cache_init_paged(b, n, 8), jax.eval_shape(
            lambda b=b, n=n: jb.cache_init_paged(b, n, 8)))
            for b, n in ((8, 32), (4, 32), (4, 25))]
    for r in RULES:
        for mine, ref in trees:
            got = sh.cache_shardings(mine, pm, _rules(r))
            want = jsh.cache_shardings(ref, jm, r)
            assert jax.tree.map(_spec, want) == \
                jax.tree.map(_spec, got, is_leaf=lambda x: isinstance(
                    x, sh.NamedSharding))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_table_and_batch_specs_match_jax(mesh):
    jm, pm = _meshes(mesh)
    for r in RULES:
        for batch in (0, 3, 6, 8, 16):       # divisible and not
            assert _spec(sh.page_table_sharding(pm, batch, _rules(r))) == \
                _spec(jsh.page_table_sharding(jm, batch, r))
        for ndim in (1, 2, 3):
            assert _spec(sh.batch_sharding(pm, ndim, _rules(r))) == \
                _spec(jsh.batch_sharding(jm, ndim, r))


def test_partition_spec_equals_its_tuple():
    assert sh.P("data", None) == ("data", None)
    assert tuple(sh.page_table_sharding(_meshes("data8")[1], 16).spec) == \
        ("data", None)
    assert tuple(sh.page_table_sharding(_meshes("data8")[1], 6).spec) == \
        (None, None)


# -- placement ----------------------------------------------------------------


def test_place_on_the_engine_device_keeps_the_same_tensors():
    *_, cfg, bundle, params = _models("qwen3-4b")
    mesh = make_serve_meshes(8, devices=[CPU] * 8).decode
    assert sh.place(params, mesh) is params
    cache = bundle.cache_init_paged(2, 5, 8)
    placed = sh.place(cache, mesh)
    assert placed[0]["attn"]["kp"] is cache[0]["attn"]["kp"]


def test_place_elsewhere_copies_and_leaves_the_original():
    *_, cfg, bundle, params = _models("qwen3-4b")
    mesh = Mesh(np.array([META, META], dtype=object), ("data",))
    moved = sh.place(params, mesh)
    assert moved is not params
    assert all(p.device == META for p in moved.parameters())
    assert all(p.device == CPU for p in params.parameters())
    assert [n for n, _ in moved.named_parameters()] == \
        [n for n, _ in params.named_parameters()]


@pytest.mark.parametrize("devices", ([CPU, META], [META, CPU, CPU]))
def test_engine_mesh_over_two_physical_devices_raises(devices):
    mesh = Mesh(np.array(devices, dtype=object), ("data",))
    assert len(mesh.physical_devices()) == 2
    # one engine over several devices runs on a rank mesh
    with pytest.raises(NotImplementedError, match="rank mesh"):
        sh.engine_device(mesh)
    with pytest.raises(NotImplementedError):
        sh.place({"a": torch.zeros(2)}, mesh)


# -- page migration against JAX's ---------------------------------------------


def _seeded_pools(arch, b=3, n_pages=9, page=8, seed=0):
    jcfg, jb, *_ = _models(arch)
    cfg, bundle = _models(arch)[3:5]
    jcache = jb.cache_init_paged(b, n_pages, page)
    rng = np.random.default_rng(seed)
    vals = jax.tree.map(
        lambda a: (rng.integers(0, 40, a.shape) if a.dtype == jnp.int32
                   else rng.standard_normal(a.shape)).astype(np.float32),
        jcache)
    jcache = jax.tree.map(lambda v, a: jnp.asarray(v, a.dtype), vals, jcache)
    mine = bundle.cache_init_paged(b, n_pages, page)
    for seg, jseg in zip(mine, jcache):
        for k, v in seg["attn"].items():
            v.copy_(torch.from_numpy(np.array(
                jseg["attn"][k].astype(jnp.float32))).to(v.dtype))
    return jcache, mine


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or \
        x.dtype.name == "bfloat16" else x


def _equal(jtree, ttree):
    jl = jax.tree.leaves(jtree)
    tl = jax.tree.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(_as_np(b), _as_np(a))


@pytest.mark.parametrize("arch", ("qwen3-4b", "minicpm3-4b"))
def test_gather_and_scatter_pages_match_jax(arch):
    jcache, mine = _seeded_pools(arch)
    keys = set(mine[0]["attn"]) - {"len"}
    assert keys == ({"ckvp", "krp"} if arch == "minicpm3-4b"
                    else {"kp", "vp"})
    src = [5, 2, 7]
    jblk = jax_t.lm_gather_pages(jcache, jnp.asarray(src, jnp.int32))
    blk = t.lm_gather_pages(mine, torch.tensor(src))
    _equal(jblk, blk)
    # the blocks of another seeded pool, written into three pages
    jother, other = _seeded_pools(arch, seed=1)
    jsrc = jax_t.lm_gather_pages(jother, jnp.asarray([1, 3, 4], jnp.int32))
    tsrc = t.lm_gather_pages(other, torch.tensor([1, 3, 4]))
    dst = [6, 1, 8]
    want = jax_t.lm_scatter_pages(jcache, jsrc, jnp.asarray(dst, jnp.int32),
                                  np.int32(1), np.int32(17))
    got = t.lm_scatter_pages(mine, tsrc, torch.tensor(dst), 1, 17)
    assert got is mine                      # in place
    _equal(want, got)
    assert mine[0]["attn"]["len"][:, 1].tolist() == \
        [17] * mine[0]["attn"]["len"].shape[0]


def test_bundle_exposes_page_migration():
    for arch in PAGED:
        bundle = _models(arch)[4]
        assert bundle.gather_pages is t.lm_gather_pages
        assert bundle.scatter_pages is t.lm_scatter_pages
    assert _models("rwkv6-1.6b")[4].gather_pages is None
    assert _models("rwkv6-1.6b")[4].scatter_pages is None


# -- the config fields --------------------------------------------------------


def test_config_fields_contain_jax_s():
    mine = {f.name: f for f in dataclasses.fields(ModelConfig)}
    ref = {f.name: f for f in dataclasses.fields(JaxModelConfig)}
    assert set(ref) <= set(mine)
    for name in ("scan_layers", "act_sp", "mesh_dp_axes", "mesh_tp_axis",
                 "mesh_pool_axis"):
        assert mine[name].default == ref[name].default, name
    for arch in FAMILIES:
        a, b = get_config(arch), jax_get_config(arch)
        for name in ("scan_layers", "act_sp", "mesh_dp_axes",
                     "mesh_tp_axis", "mesh_pool_axis"):
            assert getattr(a, name) == getattr(b, name), (arch, name)
