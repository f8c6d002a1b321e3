"""What the spawned ranks of ``tests/test_torch_dist.py``,
``tests/test_torch_parallel.py``, ``tests/test_torch_shard_steps.py`` and
``tests/test_torch_shard_families.py`` run
(``repro_torch.launch.spawn``).

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


# -- the sharded steps (tests/test_torch_shard_steps.py) ----------------------


def _own_shards(params, specs, shapes, mesh):
    """Leaves this rank holds in storage larger than its shard, or at a
    shape other than its shard's (names)."""
    from repro_torch.parallel.sharding import shard_of
    bad = []
    for name, t in params.named_parameters():
        whole = torch.empty(shapes[name], device="meta")
        want = tuple(shard_of(whole, specs[name].spec, mesh).shape)
        if tuple(t.shape) != want or \
                t.untyped_storage().nbytes() != t.numel() * t.element_size():
            bad.append(name)
    return bad


def _gathered(x, mesh, dims):
    """``x`` gathered whole over the mesh axes ``dims`` names
    ({axis: dim})."""
    from repro_torch.parallel.collectives import all_gather
    for axis, dim in dims.items():
        x = all_gather(x.contiguous(), mesh, axis, dim)
    return x


def _dp(mesh):
    """The batch axes of ``mesh``: ``data``, or the ``("pod", "data")``
    plane."""
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def _dp_size(mesh):
    return int(np.prod([mesh.shape[a] for a in mesh.axis_names
                        if a != "model"]))


def _rows(batch, mesh):
    """This rank's rows of every leaf of ``batch`` (cut over the batch
    axes)."""
    n = next(iter(batch.values())).shape[0] // _dp_size(mesh)
    i = mesh.axis_index(_dp(mesh))
    return {k: v[i * n:(i + 1) * n] for k, v in batch.items()}



def _shard_train(cfg, tree, mesh, batch, steps_n, own_ref, outside):
    """``steps_n`` sharded train steps from ``tree`` on ``batch`` (every
    row; each rank takes its own), the first one's collectives recorded;
    with ``own_ref`` also the port's unsharded step on the same numbers,
    with ``outside`` :func:`_backward_outside`."""
    import copy

    from repro_torch.parallel.collectives import count_collectives

    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.parallel.sharding import (gather_shards,
                                               param_shardings, place)
    full = params_from_numpy(cfg, tree, device="cpu", dtype=cfg.pdtype)
    specs = param_shardings(full, mesh)
    b, s = batch["tokens"].shape
    step, arg_specs = steps.shard_train_step(
        cfg, mesh, InputShape("t", s, b, "train"))
    opt = steps.default_optimizer()
    ref = copy.deepcopy(full) if own_ref else None
    local = place(full, mesh, specs)
    shapes = {n: tuple(p.shape) for n, p in full.named_parameters()}
    del full
    ost = opt.init(local)
    mine = _rows(batch, mesh)
    out = {"metrics": [], "bad_shards": _own_shards(local, specs, shapes,
                                                    mesh)}
    for i in range(steps_n):
        with count_collectives() as tally:
            local, ost, m = step(local, ost, mine)
        if i == 0:
            out["collectives"] = tally
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    out["step"] = int(ost.step)
    if outside:
        out["backward_outside"] = _backward_outside(cfg, local, mine, mesh,
                                                    specs)
    # every rank takes part in the gathers; rank 0 returns them
    whole = (params_to_numpy(gather_shards(local, mesh, specs)),
             params_to_numpy(gather_shards(ost.m, mesh, specs)))
    if mesh.rank != 0:
        return out
    out["params"], out["m"] = whole
    if own_ref:
        rstep = steps.make_train_step(cfg, opt, device="cpu")
        rst = opt.init(ref)
        out["ref_metrics"] = []
        for _ in range(steps_n):
            ref, rst, m = rstep(ref, rst, batch)
            out["ref_metrics"].append((float(m["loss"]),
                                       float(m["grad_norm"])))
        out["ref_params"] = params_to_numpy(ref)
        out["ref_m"] = params_to_numpy(rst.m)
    return out


def _backward_outside(cfg, params, batch, mesh, specs):
    """The loss under the step's shards, its backward outside them (as
    the card's autograd thread runs it): the recomputed layers must
    enter the shards themselves.  Returns the gradients' sum of squares
    against the one of a backward inside."""
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.sharding import ShardingRules, step_shards
    bundle = build_model(cfg, device="cpu")
    shards = steps._shards(specs, params, mesh, ShardingRules(), cfg)
    sums = []
    for inside in (True, False):
        params.requires_grad_(True)
        with step_shards(shards):
            loss = bundle.loss(params, batch)
            if inside:
                loss.backward()
        if not inside:
            loss.backward()
        sums.append(sum(float((p.grad.double() ** 2).sum())
                        for p in params.parameters()))
        for p in params.parameters():
            p.grad = None
    params.requires_grad_(False)
    return sums


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def _shard_serve(cfg, tree, mesh, tokens, batch, s_max, steps_n,
                 feed_zeros=False, enc_out=None):
    """``steps_n`` sharded greedy serve steps of ``batch`` rows from an
    empty cache (``feed_zeros``: token 0 at every step, as JAX's
    ``tests/test_distributed.py`` feeds it; ``enc_out``: the
    encoder-decoder's input, every row): this rank's logits shards, and
    (rank 0) the whole cache after the last step."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel.sharding import (cache_shardings,
                                               gather_shards,
                                               param_shardings, place)
    full = params_from_numpy(cfg, tree, device="cpu")
    local = place(full, mesh, param_shardings(full, mesh))
    step, (_, cache_specs, *_) = steps.shard_serve_step(
        cfg, mesh, InputShape("d", s_max, batch, "decode"))
    c_shard = cache_shardings(cache_specs, mesh)
    cache = place(steps.build_model(cfg, "cpu").cache_init(batch, s_max),
                  mesh, c_shard)
    dp = _dp_size(mesh)
    b_div = batch % dp == 0
    i = mesh.axis_index(_dp(mesh))
    rows = slice(i * (batch // dp), (i + 1) * (batch // dp)) \
        if b_div else slice(0, batch)
    v_div = cfg.vocab % mesh.shape["model"] == 0
    extra = () if enc_out is None else (enc_out[rows],)
    tok = torch.zeros(batch, dtype=torch.int32) if feed_zeros \
        else tokens[:batch, 0].clone()
    pos = torch.zeros(batch, dtype=torch.int32)
    segs = [cache] if cfg.family == "encdec" else cache
    attn = [seg["attn"] for seg in segs if "attn" in seg]
    out = {"logits": [], "tokens": [], "cache_k_local": tuple(
        next(v for k, v in attn[0].items() if k != "len").shape)
        if attn else None}
    for _ in range(steps_n):
        logits, cache = step(local, cache, tok[rows], pos[rows], *extra)
        out["logits"].append(logits.numpy().copy())
        dims = {"model": 1} if v_div else {}
        if b_div:
            dims[_dp(mesh)] = 0
        whole = _gathered(logits, mesh, dims)
        greedy = whole.argmax(-1).to(torch.int32)
        out["tokens"].append(greedy.tolist())
        if not feed_zeros:
            tok = greedy
        pos = pos + 1
    got = gather_shards(cache, mesh, c_shard)
    if mesh.rank == 0:
        out["cache_tree"] = _numpy_tree(got)
    return out


def _first_heads(cfg, tree, mesh):
    """(h0, h1, kv0, kv1): the query and KV heads this rank attends in
    the first layer, inside a sharded step's shards."""
    from repro_torch.launch import steps
    from repro_torch.models.attention import heads
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel.sharding import (ShardingRules,
                                               param_shardings, place,
                                               step_shards)
    full = params_from_numpy(cfg, tree, device="cpu")
    specs = param_shardings(full, mesh)
    local = place(full, mesh, specs)
    with step_shards(steps._shards(specs, local, mesh, ShardingRules(),
                                   cfg)):
        hs = heads(cfg, local.segments[0][0].attn)
    return hs.h0, hs.h1, hs.kv0, hs.kv1


def shard_step_cases(weights, cases, inputs):
    """Each case of ``tests/test_torch_shard_steps.py`` and
    ``tests/test_torch_shard_families.py`` on a rank mesh over the 8
    ranks: sharded train steps (``kernel_mode="ref"``), the prefill step
    and greedy serve steps (kernel mode: the plain versions here), on
    a ``("data", "model")`` mesh or, where the case's mesh has three
    axes, a ``("pod", "data", "model")`` one.  The collectives of each
    prefill step are recorded (``count_collectives``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel.collectives import count_collectives
    from repro_torch.parallel.sharding import param_shardings, place

    out = {}
    for name, case in cases.items():
        axes = ("pod", "data", "model")[-len(case["mesh"]):]
        mesh = make_debug_mesh(case["mesh"], axes, ranks=True)
        if not mesh.member:
            continue
        tree = weights[case["weights"]]
        batch = {k: torch.from_numpy(v)
                 for k, v in inputs[case["weights"]].items()}
        enc_out = batch.pop("enc_out", None)
        tokens = batch["tokens"]
        ov = case.get("overrides", {})
        got = {"coords": mesh.coords}
        if case.get("train"):
            cfg = get_config(case["arch"], smoke=True, kernel_mode="ref",
                             **ov)
            got["train"] = _shard_train(cfg, tree, mesh, batch,
                                        case["train"],
                                        case.get("own_ref", False),
                                        case.get("outside", False))
        if case.get("prefill"):
            cfg = get_config(case["arch"], smoke=True,
                             kernel_mode=case.get("prefill_mode", "kernel"),
                             **ov)
            full = params_from_numpy(cfg, tree, device="cpu")
            step, _ = steps.shard_prefill_step(
                cfg, mesh, InputShape("p", tokens.shape[1], tokens.shape[0],
                                      "prefill"))
            mine = _rows({k: v for k, v in batch.items() if k != "labels"},
                         mesh)
            local = place(full, mesh, param_shardings(full, mesh))
            with count_collectives() as tally:
                got["prefill"] = step(local, mine).numpy()
            got["prefill_collectives"] = tally
        if case.get("heads"):
            got["heads"] = _first_heads(get_config(case["arch"], smoke=True,
                                                   **ov), tree, mesh)
        for rows in case.get("serve", ()):
            cfg = get_config(case["arch"], smoke=True, **ov)
            got[f"serve_{rows}"] = _shard_serve(
                cfg, tree, mesh, tokens, rows, case["s_max"], 2,
                case.get("feed_zeros", False), enc_out)
        out[name] = got
    return {"cases": out, "jax_loaded": _jax_loaded()}
