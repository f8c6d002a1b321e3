"""``parallel/{compress,pp,ep_dispatch}.py`` against the JAX package:
int8 gradient all-reduce with error feedback, GPipe pipeline stages and
all-to-all expert-parallel MoE dispatch.

One spawn of 8 gloo ranks runs every multi-rank case
(``tests/torch_rank_cases.py``; the ranks load no JAX), and one
subprocess with 8 forced host devices computes every JAX reference on
the same numpy inputs, as ``tests/test_compress.py`` runs JAX's own
8-device case:

- ``compressed_psum`` at 8 ranks equal to JAX's ``shard_map`` result bit
  for bit (the sum is int32), two magnitudes of gradient, and the tree
  version;
- ``pipeline_forward`` at 4 stages within 2e-5 of JAX's and of the
  sequential composition, on a (2, 4) mesh and on 4 of the 8 ranks;
- ``make_ep_moe`` on (data 2, model 4): dropless within 2e-4 of JAX's
  ``ep_moe_reference``, and at ``capacity_per_shard=2``, where pairs
  drop, within 1e-5 of JAX's ``make_ep_moe``.

In this process, beside JAX's: ``quantize``/``dequantize`` bit for bit,
``ep_moe_reference``, and a world of one (an in-process gloo group),
where the collectives move nothing.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_rank_cases as rc
from repro.parallel.compress import dequantize as jax_dequantize
from repro.parallel.compress import quantize as jax_quantize
from repro.parallel.ep_dispatch import \
    ep_moe_reference as jax_ep_moe_reference
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.spawn import spawn
from repro_torch.parallel import (compressed_grad_mean, compressed_psum,
                                  dequantize, ep_moe_reference, make_ep_moe,
                                  pipeline_forward, quantize)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
S, M = 4, 6                       # pipeline stages, microbatches
T, D, F, E, K = 32, 16, 32, 8, 2  # tokens, width, FFN, experts, top-k


def _inputs():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((8, 256)).astype(np.float32)
    g *= (10.0 ** rng.integers(-2, 3, size=(8, 1))).astype(np.float32)
    r = np.random.default_rng(1)
    ws = (r.standard_normal((S, 16, 16)) * 0.3).astype(np.float32)
    x_pp = r.standard_normal((M, 2, 16)).astype(np.float32)
    r = np.random.default_rng(2)
    return {"g": g,
            "g_small": (rng.standard_normal((8, 128)) * 0.01).astype(
                np.float32),
            "ws": ws, "x_pp": x_pp,
            "x": r.standard_normal((T, D)).astype(np.float32),
            "router": (r.standard_normal((D, E)) * 0.3).astype(np.float32),
            "wg": (r.standard_normal((E, D, F)) * 0.2).astype(np.float32),
            "wu": (r.standard_normal((E, D, F)) * 0.2).astype(np.float32),
            "wd": (r.standard_normal((E, F, D)) * 0.2).astype(np.float32),
            "top_k": np.int64(K)}


_JAX = """
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.launch.mesh import make_debug_mesh
    from repro.parallel.compress import compressed_grad_mean, compressed_psum
    from repro.parallel.ep_dispatch import ep_moe_reference, make_ep_moe
    from repro.parallel.pp import pipeline_forward

    assert jax.device_count() == 8
    with open(sys.argv[1], "rb") as f:
        t = pickle.load(f)
    out = {}
    mesh = make_debug_mesh((8,), ("data",))
    spec = (P("data"), P("data"))
    psum = jax.shard_map(lambda g, r: compressed_psum(g, r, "data"),
                         mesh=mesh, in_specs=spec, out_specs=spec)
    for name in ("g", "g_small"):
        g = jnp.asarray(t[name])
        out["compress_" + name] = tuple(
            np.asarray(a) for a in psum(g, jnp.zeros_like(g)))
    grads = {"w": jnp.asarray(t["g"]), "b": [jnp.asarray(t["g_small"][:, :4])]}
    tree = jax.shard_map(lambda g, r: compressed_grad_mean(g, r, "data"),
                         mesh=mesh, in_specs=spec, out_specs=spec)
    mean, res = tree(grads, jax.tree.map(jnp.zeros_like, grads))
    out["grad_mean"] = tuple({"w": np.asarray(a["w"]),
                              "b": np.asarray(a["b"][0])} for a in (mean, res))
    stages = make_debug_mesh((4,), ("stage",))
    out["pp"] = np.asarray(pipeline_forward(
        lambda w, a: jnp.tanh(a @ w), jnp.asarray(t["ws"]),
        jnp.asarray(t["x_pp"]), stages, axis="stage"))
    ep = make_debug_mesh((2, 4), ("data", "model"))
    args = [jnp.asarray(t[k]) for k in ("x", "router", "wg", "wu", "wd")]
    k = int(t["top_k"])
    out["ep_reference"] = np.asarray(ep_moe_reference(*args, k))
    with ep:
        for cap in (t["x"].shape[0] * k, 2):
            fn = make_ep_moe(ep, top_k=k, n_experts=t["router"].shape[1],
                             capacity_per_shard=cap)
            out["ep_%d" % cap] = np.asarray(jax.jit(fn)(*args))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """Every JAX reference, from one process with 8 host devices."""
    d = tmp_path_factory.mktemp("jax_parallel")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(_inputs(), f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX), str(d / "in.pkl"),
         str(d / "out.pkl")], capture_output=True, text=True, env=env,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks():
    return spawn(rc.parallel_cases, WORLD, _inputs(), timeout=600)


def test_spawned_ranks_load_no_jax(ranks):
    assert len(ranks) == WORLD
    assert not any(r["jax_loaded"] for r in ranks)


@pytest.mark.parametrize("name", ["g", "g_small"])
def test_compressed_psum_8_ranks_bit_equal_to_jax(ranks, jax_refs, name):
    want_mean, want_res = jax_refs[f"compress_{name}"]
    for r, got in enumerate(ranks):
        mean, res = got["cases"][f"compress_{name}"]
        np.testing.assert_array_equal(mean[0], want_mean[r])
        np.testing.assert_array_equal(res[0], want_res[r])
    g = _inputs()[name]
    # the reference's bound: within the largest scale of the exact mean
    assert np.abs(want_mean[0] - g.mean(0)).max() <= np.abs(g).max() / 127


def test_compressed_grad_mean_tree_matches_jax(ranks, jax_refs):
    want_mean, want_res = jax_refs["grad_mean"]
    for r, got in enumerate(ranks):
        mean, res = got["cases"]["grad_mean"]
        for k in ("w", "b"):
            np.testing.assert_allclose(mean[k][0], want_mean[k][r],
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(res[k][0], want_res[k][r],
                                       rtol=0, atol=1e-6)


def test_pipeline_forward_4_stages_matches_jax(ranks, jax_refs):
    t = _inputs()
    seq = t["x_pp"]
    for i in range(S):
        seq = np.tanh(seq @ t["ws"][i])
    np.testing.assert_allclose(jax_refs["pp"], seq, rtol=2e-5, atol=2e-5)
    for r, got in enumerate(ranks):
        for key in ("pp", "pp_four"):
            out = got["cases"][key]
            if key == "pp_four" and r >= 4:
                assert out is None          # not a rank of that mesh
                continue
            np.testing.assert_allclose(out, jax_refs["pp"], rtol=2e-5,
                                       atol=2e-5)
            np.testing.assert_allclose(out, seq, rtol=2e-5, atol=2e-5)


def test_ep_moe_dropless_matches_the_reference(ranks, jax_refs):
    for got in ranks:
        out = got["cases"][f"ep_{T * K}"]
        np.testing.assert_allclose(out, jax_refs["ep_reference"], rtol=0,
                                   atol=2e-4)
        np.testing.assert_allclose(got["cases"]["ep_reference"],
                                   jax_refs["ep_reference"], rtol=0,
                                   atol=1e-5)


def test_ep_moe_drops_the_pairs_jax_drops(ranks, jax_refs):
    want = jax_refs["ep_2"]
    # capacity 2 drops pairs: far from the dropless result
    assert np.abs(want - jax_refs["ep_reference"]).max() > 1e-2
    for got in ranks:
        np.testing.assert_allclose(got["cases"]["ep_2"], want, rtol=0,
                                   atol=1e-5)
        # 6 experts do not split over the 4 shards of "model"
        assert got["cases"]["ep_uneven"] == "raised"


# -- in this process ------------------------------------------------------------


@pytest.mark.parametrize("seed,shape,scale", [(0, (513,), 1.0),
                                              (1, (4, 64), 1e-3),
                                              (2, (7,), 0.0)])
def test_quantize_bit_equal_to_jax(seed, shape, scale):
    g = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    q, s = quantize(torch.as_tensor(g))
    jq, js = jax_quantize(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js) and float(s) > 0
    np.testing.assert_array_equal(dequantize(q, s).numpy(),
                                  np.asarray(jax_dequantize(jq, js)))


def test_ep_moe_reference_matches_jax():
    t = _inputs()
    args = [t[k] for k in ("x", "router", "wg", "wu", "wd")]
    want = jax_ep_moe_reference(*(jnp.asarray(a) for a in args), K)
    got = ep_moe_reference(*(torch.as_tensor(a) for a in args), K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_of_one(world_of_one):
    """``tests/test_compress.py``'s one-device cases, one stage, and one
    expert shard: nothing moves, every result is the local one."""
    rng = np.random.default_rng(1)
    mesh = make_debug_mesh((1,), ("data",), ranks=True)
    g = torch.as_tensor(rng.standard_normal((1, 64)).astype(np.float32))
    mean, res = compressed_psum(g, torch.zeros_like(g), mesh, "data")
    torch.testing.assert_close(mean + res, g, rtol=0, atol=1e-6)
    torch.testing.assert_close(mean[0], dequantize(*quantize(g[0])),
                               rtol=0, atol=1e-6)
    # error feedback: a constant gradient reduced 4 times sums to 4 g
    g = g * 1e-3
    r, total = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(4):
        m, r = compressed_psum(g, r, mesh, "data")
        total = total + m
    assert float((total - 4 * g).abs().max()) <= float(g.abs().max()) / 2
    mean, res = compressed_grad_mean({"w": g, "b": [g[:, :4]]},
                                     {"w": torch.zeros_like(g),
                                      "b": [torch.zeros(1, 4)]}, mesh, "data")
    assert set(mean) == {"w", "b"} and len(res["b"]) == 1
    torch.testing.assert_close(mean["b"][0] + res["b"][0], g[:, :4],
                               rtol=0, atol=1e-6)

    t = {k: torch.as_tensor(v) for k, v in _inputs().items()}
    one = make_debug_mesh((1,), ("stage",), ranks=True)
    out = pipeline_forward(lambda w, a: torch.tanh(a @ w), t["ws"][:1],
                           t["x_pp"], one, axis="stage")
    torch.testing.assert_close(out, torch.tanh(t["x_pp"] @ t["ws"][0]),
                               rtol=0, atol=0)

    ep = make_debug_mesh((1, 1), ("data", "model"), ranks=True)
    args = [t[k] for k in ("x", "router", "wg", "wu", "wd")]
    fn = make_ep_moe(ep, top_k=K, n_experts=E, capacity_per_shard=T * K)
    torch.testing.assert_close(fn(*args), ep_moe_reference(*args, K),
                               rtol=0, atol=2e-4)
