"""Train, prefill and serve steps: the counterpart of
``repro.launch.steps``, for every family (the encoder-decoder's prefill
step is its encoder, and its serve step takes the encoder output).

  * train_step(params, opt_state, batch) -> (params, opt_state, metrics)
  * prefill_step(params, batch) -> last-position logits
  * serve_step(params, cache, token, pos[, enc_out]) -> (logits, cache)

The sharded wrappers ``shard_train_step``, ``shard_prefill_step`` and
``shard_serve_step`` take JAX's arguments (a mesh, an ``InputShape``,
``ShardingRules``) and return ``(step, arg_specs)``, the specs from
``launch/specs.py``.  JAX's are ``jax.jit`` with in and out shardings,
for which GSPMD inserts the collectives; here the mesh is a
``RankMesh`` of ``("data", "model")`` (one process a rank), each rank
calls the step with its shards (``parallel/sharding.py::place`` cuts
them by ``param_shardings``, ``batch_sharding`` and
``cache_shardings``) and gets its shards of JAX's outputs back; the
models write the collectives themselves inside ``step_shards``
(tensor parallelism over ``model``, FSDP and data parallelism over
``data``).  They cover the GQA decoders with ``attn`` and ``moe``
layers; MLA, the recurrent families, the encoder-decoder and
``act_sp`` raise ``NotImplementedError``.  :func:`init_shards` draws a
model too large for one card leaf by leaf and keeps each rank's shard.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.launch import specs as _specs
from repro_torch.launch.mesh import RankMesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import NamedParams, named
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamW, OptState, warmup_cosine
from repro_torch.parallel.collectives import all_gather, psum
from repro_torch.parallel.sharding import (ShardingRules, StepShards,
                                           batch_psum, cache_shardings,
                                           leaf_cuts, model_cut,
                                           param_shardings, shard_of,
                                           step_shards)


def default_optimizer(total_steps: int = 10_000) -> AdamW:
    return AdamW(lr=warmup_cosine(3e-4, 200, total_steps), weight_decay=0.1)


def _on(device: torch.device, batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, optimizer: Optional[AdamW] = None,
                    device: Union[None, str, torch.device] = None
                    ) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: the loss and its gradients by autograd
    (``bundle.loss``), then one AdamW update of ``params`` (an ``LM``
    whose matrices are stored in ``cfg.param_dtype``) in place.  The
    batch is numpy or tensors, ``tokens`` and ``labels`` (B, S); the
    metrics are 0-d device tensors (reading them syncs the host).  Runs
    on ``cuda`` unless ``device`` says otherwise.

    In ``kernel`` mode the dispatchers refuse to run under autograd
    (``NotImplementedError``), as JAX's ``pallas`` mode raises under
    ``value_and_grad``: training takes ``kernel_mode="ref"``, and nothing
    switches it silently.  Gradients are dropped after the update, so
    between steps the state holds parameters, m and v only."""
    bundle = build_model(cfg, device)
    opt = optimizer or default_optimizer()

    def train_step(params, opt_state, batch):
        return _train(cfg, bundle, opt, params, opt_state, batch)

    return train_step


def _train(cfg: ModelConfig, bundle, opt: AdamW, params, opt_state, batch,
           shards: Optional[StepShards] = None):
    """One train step; in a sharded step (``shards``) the loss is this
    rank's batch rows' share of the whole batch's mean, the gradients of
    leaves that ``data`` does not cut are summed over the batch axis
    (FSDP's gathers reduce-scatter the others), and the loss reported is
    the whole batch's."""
    leaves = dict(params.named_parameters())
    low = [k for k, p in leaves.items() if p.dtype != cfg.pdtype]
    if low:
        raise ValueError(
            f"{low[0]} is stored in {leaves[low[0]].dtype}, not "
            f"{cfg.pdtype}: build the trainer's parameters with "
            "dtype=cfg.pdtype (AdamW's updates would round away)")
    params.requires_grad_(True)
    with (contextlib.nullcontext() if shards is None
          else step_shards(shards)):
        loss = bundle.loss(params, _on(bundle.device, batch))
        loss.backward()
        if shards is not None:
            _sum_over_batch(shards, [p for p in leaves.values()
                                     if "data" not in shards.axes(p)])
            loss = batch_psum(loss.detach())
        grads = NamedParams((k, p.grad) for k, p in leaves.items())
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
    del grads
    for p in leaves.values():
        p.grad = None
    return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}


def make_prefill_step(cfg: ModelConfig,
                      device: Union[None, str, torch.device] = None
                      ) -> Callable:
    """``prefill_step(params, batch) -> (B, V)`` float32 logits at the
    last position of ``batch["tokens"]`` (B, S), through the cache-free
    forward (``ModelBundle.apply``); for the encoder-decoder the encoder
    output (B, S_enc, D) of ``batch["frames"]`` (``ModelBundle.encode``),
    as JAX's returns it.  Runs on ``cuda`` unless ``device`` says
    otherwise."""
    bundle = build_model(cfg, device)

    def prefill_step(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            if cfg.family == "encdec":
                return bundle.encode(params, batch["frames"])
            logits = bundle.apply(params, batch["tokens"])
        return logits[:, -1, :].float()

    return prefill_step


def make_serve_step(cfg: ModelConfig,
                    device: Union[None, str, torch.device] = None
                    ) -> Callable:
    """``serve_step(params, cache, token, pos) -> (logits (B, V) float32,
    cache)``: one decode step on a contiguous cache
    (``ModelBundle.decode_step``), the cache updated in place; the
    encoder-decoder's takes ``enc_out`` last, as JAX's.  Runs on ``cuda``
    unless ``device`` says otherwise."""
    bundle = build_model(cfg, device)

    if cfg.family == "encdec":
        def serve_step(params, cache, token, pos, enc_out):
            with torch.inference_mode():
                return bundle.decode_step(params, enc_out, cache, token, pos)
    else:
        def serve_step(params, cache, token, pos):
            with torch.inference_mode():
                return bundle.decode_step(params, cache, token, pos)

    return serve_step


# ---------------------------------------------------------------------------
# Sharded wrappers
# ---------------------------------------------------------------------------

_DEFERRED = "ROADMAP.md §A4 item 4 (the sharded steps' next slice)"


def _check_sharded(cfg: ModelConfig, mesh) -> None:
    if cfg.attn_kind == "mla":
        raise NotImplementedError(
            f"{cfg.arch}: MLA under tensor parallelism waits for {_DEFERRED}")
    if cfg.family in ("ssm", "hybrid", "encdec"):
        raise NotImplementedError(
            f"{cfg.arch}: the {cfg.family} family's sharded steps wait for "
            f"{_DEFERRED}")
    if cfg.act_sp:
        raise NotImplementedError(f"act_sp waits for {_DEFERRED}")
    if "pod" in mesh.axis_names:
        raise NotImplementedError(f"a pod axis: {_DEFERRED}")
    if not isinstance(mesh, RankMesh):
        raise ValueError(f"the sharded steps run on a rank mesh "
                         f"(make_debug_mesh(..., ranks=True)), got {mesh}")
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(f"the sharded steps need a ('data', 'model') "
                         f"mesh, got {mesh.axis_names}")


def _bind_mesh_axes(cfg: ModelConfig, mesh) -> ModelConfig:
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return dataclasses.replace(cfg, mesh_dp_axes=dp or ("data",))


def _dp_size(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def _shards(specs, params, mesh, batch_axis: Optional[str] = "data",
            cache_seq_axis: Optional[str] = None) -> StepShards:
    return StepShards(mesh, leaf_cuts(specs, params, mesh), batch_axis,
                      cache_seq_axis)


def _sum_over_batch(shards: StepShards, leaves) -> None:
    """Sum, in place, the gradients of ``leaves`` over the batch axis,
    in one flat buffer."""
    if shards.lines(shards.batch_axis) == 1 or not leaves:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in leaves])
    flat = psum(flat, shards.mesh, shards.batch_axis)
    i = 0
    for p in leaves:
        n = p.grad.numel()
        p.grad.copy_(flat[i:i + n].view_as(p.grad))
        i += n


def _step_device(mesh, device):
    return mesh.device if device is None else device


def _opt_specs(p_specs) -> OptState:
    """JAX's ``jax.eval_shape(opt.init, p_specs)``: float32 moments
    beside every parameter, a 0-d int32 step."""
    def like(tree):
        if isinstance(tree, dict):
            return {k: like(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [like(v) for v in tree]
        return torch.empty(tree.shape, dtype=torch.float32,
                           device=_specs.META)
    return OptState(step=torch.empty((), dtype=torch.int32,
                                     device=_specs.META),
                    m=like(p_specs), v=like(p_specs))


def shard_train_step(cfg: ModelConfig, mesh, shape,
                     rules: Optional[ShardingRules] = None,
                     optimizer: Optional[AdamW] = None,
                     donate: bool = True,
                     device: Union[None, str, torch.device] = None):
    """``(train_step, (p_specs, o_specs, b_specs))``.  ``train_step(
    params, opt_state, batch)`` takes this rank's shards (parameters and
    moments cut by ``param_shardings``, the batch rows by
    ``batch_sharding``) and returns its shards of the new parameters and
    moments, updated in place (``donate`` has nothing to free), and the
    whole batch's loss and grad norm on every rank.  The batch must
    divide over ``data``, as JAX's in-sharding requires."""
    _check_sharded(cfg, mesh)
    rules = rules or ShardingRules()
    cfg = _bind_mesh_axes(cfg, mesh)
    if shape.global_batch % _dp_size(mesh):
        raise ValueError(f"batch {shape.global_batch} does not divide over "
                         f"{_dp_size(mesh)} data slots")
    bundle = build_model(cfg, _step_device(mesh, device))
    opt = optimizer or default_optimizer()
    specs = param_shardings(_specs.meta_model(cfg), mesh, rules)
    p_specs = _specs.param_specs(cfg)

    def train_step(params, opt_state, batch):
        return _train(cfg, bundle, opt, params, opt_state, batch,
                      _shards(specs, params, mesh))

    return train_step, (p_specs, _opt_specs(p_specs),
                        _specs.train_batch_specs(cfg, shape))


def _vocab_cut(cfg: ModelConfig, params) -> bool:
    return model_cut(params.embed if cfg.tie_embeddings
                     else params.unembed) is not None


def shard_prefill_step(cfg: ModelConfig, mesh, shape,
                       rules: Optional[ShardingRules] = None,
                       device: Union[None, str, torch.device] = None):
    """``(prefill_step, (p_specs, b_specs))``.  ``prefill_step(params,
    batch)`` takes this rank's parameter shards and batch rows and
    returns its rows of the last position's float32 logits over the
    whole vocab (JAX's ``P(dp, None)``)."""
    _check_sharded(cfg, mesh)
    rules = rules or ShardingRules()
    if shape.global_batch % _dp_size(mesh):
        raise ValueError(f"batch {shape.global_batch} does not divide over "
                         f"{_dp_size(mesh)} data slots")
    bundle = build_model(cfg, _step_device(mesh, device))
    specs = param_shardings(_specs.meta_model(cfg), mesh, rules)
    b_specs = _specs.train_batch_specs(cfg, shape)
    b_specs.pop("labels")

    def prefill_step(params, batch):
        with torch.inference_mode(), \
                step_shards(_shards(specs, params, mesh)):
            logits = bundle.apply(params, batch["tokens"])[:, -1, :].float()
            if _vocab_cut(cfg, params):
                logits = all_gather(logits, mesh, "model", dim=1)
        return logits

    return prefill_step, (_specs.param_specs(cfg), b_specs)


def shard_serve_step(cfg: ModelConfig, mesh, shape,
                     rules: Optional[ShardingRules] = None,
                     donate: bool = True,
                     device: Union[None, str, torch.device] = None):
    """``(serve_step, (p_specs, cache_specs, token, pos))``.
    ``serve_step(params, cache, token, pos)`` takes this rank's
    parameter shards, its cache shards (``cache_shardings``: the batch
    cut over ``data`` where it divides, else the sequence; never cut
    over ``model``) and its rows of ``token``/``pos`` (all rows where the
    batch does not divide), updates the cache in place and returns its
    logits shard (JAX's ``P(dp if B divides, "model" if V divides)``)
    and the cache."""
    _check_sharded(cfg, mesh)
    rules = rules or ShardingRules()
    bundle = build_model(cfg, _step_device(mesh, device))
    specs = param_shardings(_specs.meta_model(cfg), mesh, rules)
    cache_specs, args = _specs.decode_arg_specs(cfg, shape)
    c_shard = cache_shardings(cache_specs, mesh, rules)
    b_div = shape.global_batch % _dp_size(mesh) == 0
    # the sequence cut of the K/V leaves (JAX's fallback), if any
    seq = "data" if not b_div and "data" in tuple(
        c_shard[0]["attn"]["k"].spec) else None

    def serve_step(params, cache, token, pos):
        shards = _shards(specs, params, mesh, "data" if b_div else None,
                         seq)
        rows = None
        if b_div and shards.lines("data") > 1:
            n = token.shape[0]
            r0 = mesh.axis_index("data") * n
            rows = (r0, r0 + n)
        # every rank holds every row's length: its own rows' are read
        # and written in place, then gathered
        view = cache if rows is None else [
            {**seg, "attn": {**seg["attn"],
                             "len": seg["attn"]["len"][:, rows[0]:rows[1]]}}
            for seg in cache]
        with torch.inference_mode(), step_shards(shards):
            logits, _ = bundle.decode_step(params, view, token, pos)
            if rows is not None:
                for seg in cache:
                    ln = seg["attn"]["len"]
                    ln.copy_(all_gather(ln[:, rows[0]:rows[1]], mesh, "data",
                                        dim=1))
        return logits, cache

    return serve_step, (_specs.param_specs(cfg), cache_specs, args["token"],
                        args["pos"])


def init_shards(cfg: ModelConfig, generator: torch.Generator, mesh,
                rules: Optional[ShardingRules] = None,
                dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    """This rank's shard of ``bundle.init(generator, dtype)``'s
    parameters, without ever holding the whole model: each leaf is
    drawn whole on the generator's device in ``lm_init``'s order and
    with its rule (a matrix N(0, 1/d_in) in float32 then cast, a norm
    gain ones, a bias zeros), then cut to this rank's shard, so every
    rank draws the same numbers one card would.  The GQA decoders with
    ``attn``/``moe`` layers only (what the sharded steps run)."""
    _check_sharded(cfg, mesh)
    rules = rules or ShardingRules()
    meta = _specs.meta_model(cfg, dtype or cfg.adtype)
    specs = param_shardings(meta, mesh, rules)
    dev = generator.device
    memo = {}
    # lm_init's order: the embedding, the layers, then the head
    # (named_parameters lists a module's own leaves before its layers)
    order = sorted(named(meta).items(), key=lambda kv: (
        0 if kv[0] == "embed" else 1 if kv[0].startswith("segments.")
        else 2))
    for name, p in order:
        if p.dim() >= 2:
            full = torch.randn(p.shape, generator=generator, device=dev)
            full = (full * (1.0 / math.sqrt(p.shape[-2]))).to(p.dtype)
        elif name.rsplit(".", 1)[-1] in ("bq", "bk", "bv"):
            full = torch.zeros(p.shape, dtype=p.dtype, device=dev)
        else:
            full = torch.ones(p.shape, dtype=p.dtype, device=dev)
        block = shard_of(full, specs[name].spec, mesh)
        memo[id(p)] = torch.nn.Parameter(
            torch.empty_like(block, device=mesh.device,
                             memory_format=torch.contiguous_format
                             ).copy_(block), requires_grad=False)
        del full, block
    return copy.deepcopy(meta, memo)
