"""What the spawned ranks of ``tests/test_torch_dist.py`` and
``tests/test_torch_parallel.py`` run (``repro_torch.launch.spawn``).

This module imports neither JAX nor the JAX package, so the ranks never
load them: the tests compute JAX's references in their own process and
hand the ranks numpy weights.  Each function returns plain Python and
numpy values, one result per case, and reports whether JAX got loaded.
"""

import sys

import numpy as np
import torch

SERVE_STATS = ("prefill_steps", "decode_steps", "prefill_tokens",
               "decode_tokens", "admitted", "page_allocs", "cow_copies",
               "preemptions", "prefix_hits", "migrations")


def requests(cls, vocab, sizes, max_new, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=n),
                max_new=max_new) for i, n in enumerate(sizes)]


def _jax_loaded() -> bool:
    return any(m == "jax" or m.startswith(("jax.", "repro."))
               or m == "repro" for m in sys.modules)


def _pool_pages(cache):
    """The pages of the first pool leaf this rank holds (None: none),
    and whether that leaf owns its storage alone."""
    if cache is None:
        return None
    leaf = next(v for v in cache[0]["attn"].values() if v.dim() > 2)
    own = leaf.untyped_storage().nbytes() == leaf.numel() * \
        leaf.element_size()
    return leaf.shape[1] if own else ("shares storage", leaf.shape[1])


def serve_cases(weights, cases, prompts):
    """Each case (name -> arch, placement, loop keywords) through
    ``ShardedPagedServeLoop`` on rank meshes over every rank, serving
    ``prompts[name]``: (prompt, max_new) per request."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serve_meshes
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.mesh_serve import ShardedPagedServeLoop
    from repro_torch.runtime.serve_loop import Request

    out = {}
    built = {}
    for name, case in cases.items():
        arch = case["arch"]
        if arch not in built:
            cfg = get_config(arch, smoke=True)
            built[arch] = (cfg, build_model(cfg, device="cpu"),
                           params_from_numpy(cfg, weights[arch],
                                             device="cpu"))
        cfg, bundle, params = built[arch]
        meshes = make_serve_meshes(disaggregate=case["disaggregate"],
                                   ranks=True)
        loop = ShardedPagedServeLoop(cfg, bundle, params, meshes=meshes,
                                     **case["kw"])
        streams = loop.run([Request(rid=i, prompt=p, max_new=n)
                            for i, (p, n) in enumerate(prompts[name])])
        out[name] = {
            "streams": streams,
            "stats": {k: getattr(loop.stats, k) for k in SERVE_STATS},
            "split": dict(loop._split),
            "pool_pages": _pool_pages(loop.cache),
            "staging_pages": _pool_pages(getattr(loop, "cache_pf", None)),
            "migrations": [(m.slot, m.pages, m.bytes)
                           for m in loop.migration_log],
            "handoff": (loop.handoff.axis, loop.handoff.span),
            "mesh_pool_axis": loop.cfg.mesh_pool_axis}
    return {"cases": out, "jax_loaded": _jax_loaded()}


def collective_cases():
    """The collectives and the rank ``MeshChannel`` on (2, 4) meshes,
    with values that name the rank that made them."""
    from repro_torch.channels import MeshChannel
    from repro_torch.launch.mesh import make_debug_mesh, make_serve_meshes
    from repro_torch.parallel import collectives as c
    from repro_torch.parallel.sharding import P, NamedSharding, place

    mesh = make_debug_mesh((2, 4), ("data", "model"), ranks=True)
    r = mesh.rank
    x = torch.tensor([float(r), 10.0 * r + 1])
    out = {"coords": mesh.coords,
           "model_line": mesh.axis_group("model")[1],
           "data_line": mesh.axis_group("data")[1],
           "psum_model": c.psum(x, mesh, "model").tolist(),
           "pmax_data": c.pmax(x, mesh, "data").tolist(),
           "psum_all": c.psum(x, mesh, None).tolist(),
           "gather_model": c.all_gather(x[None], mesh, "model").tolist(),
           "gather_dim1": c.all_gather(x[:, None], mesh, "data",
                                       dim=1).tolist(),
           "a2a_model": c.all_to_all(
               torch.arange(4) + 100 * r, mesh, "model").tolist(),
           "ring_model": c.ppermute(x, mesh, "model",
                                    [(i, (i + 1) % 4)
                                     for i in range(4)]).tolist(),
           "one_pair": c.ppermute(x, mesh, "model", [(1, 3)]).tolist(),
           "bcast_data": c.broadcast(x.clone(), mesh, "data", 1).tolist(),
           "bcast_all": c.broadcast(x.clone(), mesh, None, 5).tolist(),
           "bf16_gather": c.all_gather(
               torch.full((2,), r + 0.5, dtype=torch.bfloat16), mesh,
               None).float().tolist(),
           "int_psum": c.psum(torch.tensor([r], dtype=torch.int32), mesh,
                              None).tolist()}
    # a mesh over the first four ranks: the others are not members
    four = make_debug_mesh((4,), ("data",), ranks=True)
    out["four_member"] = four.member
    # placement: this rank's block of a leaf, in storage of its own
    tree = {"a": torch.arange(16.0).reshape(4, 4), "b": [torch.arange(8.0)]}
    got = place(tree, mesh, {"a": NamedSharding(mesh, P("data", "model")),
                             "b": [NamedSharding(mesh, P(None))]})
    out["place"] = (got["a"].tolist(), got["a"].untyped_storage().nbytes(),
                    got["b"][0] is tree["b"][0],
                    place(tree, four) is None)
    # the serving meshes' rings: a disaggregated role-axis channel and a
    # co-located data-axis one, each through the same operations
    trace = {}
    for name, disagg in (("role", True), ("data", False)):
        meshes = make_serve_meshes(disaggregate=disagg, ranks=True)
        if disagg:
            ch = MeshChannel("ch", 3, meshes.union, "role", src=0, dst=1)
        else:
            ch = MeshChannel("ch", 3, meshes.decode, "data", src=0, dst=7)
        got = [ch.push(5), ch.push((3, 9)), ch.pop(), ch.push((-1, 2**30)),
               ch.push(7), ch.push(8), ch.peek(), ch.pop(), ch.pop(),
               ch.pop(), len(ch)]
        trace[name] = [list(g) if isinstance(g, tuple) else g
                       for g in got]
    out["channels"] = trace
    return {"cases": out, "jax_loaded": _jax_loaded()}


def dist_cases(weights, cases, prompts):
    """``tests/test_torch_dist.py``'s spawn: the collectives, then the
    serving cases."""
    return {"collectives": collective_cases(),
            "serve": serve_cases(weights, cases, prompts)}


def parallel_cases(inputs):
    """``compressed_psum``, ``pipeline_forward`` and ``make_ep_moe`` on
    the inputs the test made, at 8 ranks."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import (compressed_grad_mean, compressed_psum,
                                      ep_moe_reference, make_ep_moe,
                                      pipeline_forward)

    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    out = {}
    m8 = make_debug_mesh((8,), ("data",), ranks=True)
    i = m8.axis_index("data")
    for name in ("g", "g_small"):
        mean, res = compressed_psum(t[name][i:i + 1],
                                    torch.zeros_like(t[name][i:i + 1]), m8,
                                    "data")
        out[f"compress_{name}"] = (mean.numpy(), res.numpy())
    tree = {"w": t["g"][i:i + 1], "b": [t["g_small"][i:i + 1, :4]]}
    mean, res = compressed_grad_mean(
        tree, {"w": torch.zeros(1, 256), "b": [torch.zeros(1, 4)]}, m8,
        "data")
    out["grad_mean"] = ({"w": mean["w"].numpy(), "b": mean["b"][0].numpy()},
                        {"w": res["w"].numpy(), "b": res["b"][0].numpy()})

    stages = make_debug_mesh((2, 4), ("data", "stage"), ranks=True)
    out["pp"] = pipeline_forward(lambda w, a: torch.tanh(a @ w), t["ws"],
                                 t["x_pp"], stages, axis="stage").numpy()
    four = make_debug_mesh((4,), ("stage",), ranks=True)
    got = pipeline_forward(lambda w, a: torch.tanh(a @ w), t["ws"],
                           t["x_pp"], four, axis="stage")
    out["pp_four"] = None if got is None else got.numpy()

    ep = make_debug_mesh((2, 4), ("data", "model"), ranks=True)
    args = [t[k] for k in ("x", "router", "wg", "wu", "wd")]
    k, e = int(inputs["top_k"]), t["router"].shape[1]
    out["ep_reference"] = ep_moe_reference(*args, k).numpy()
    for cap in (t["x"].shape[0] * k, 2):
        fn = make_ep_moe(ep, top_k=k, n_experts=e, capacity_per_shard=cap)
        out[f"ep_{cap}"] = fn(*args).numpy()
    try:
        make_ep_moe(ep, top_k=k, n_experts=6, capacity_per_shard=2)
        out["ep_uneven"] = "built"
    except ValueError:
        out["ep_uneven"] = "raised"
    return {"cases": out, "jax_loaded": _jax_loaded()}
