"""GPipe-style pipeline parallelism over the ranks of a mesh axis (the
port's counterpart of ``repro.parallel.pp``).

Layers are split into S stages along a ``stage`` axis, one rank each; a
stream of M microbatches flows through the stages, ``ppermute`` moving
each stage's activation to the next stage's rank every tick.  The
schedule runs M + S - 1 ticks (fill, steady state, drain): the classic
GPipe bubble, with per-stage compute and neighbour-only communication.
``stage_fn`` is any (params, activation) -> activation function.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.parallel.collectives import broadcast, ppermute

__all__ = ["pipeline_forward"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: Any, x_microbatches: torch.Tensor, mesh,
                     axis: str = "stage") -> Optional[torch.Tensor]:
    """Run ``x_microbatches`` (M, mb, ...) through the S stages of
    ``axis`` of the rank mesh ``mesh``.

    ``stage_params``: a tree whose leaves have a leading dim S (each
    rank uses its stage's slice); ``x_microbatches`` enter stage 0.
    Returns the last stage's (M, mb, ...) outputs on every rank of the
    axis (the reference's final ``psum``, in which only the last stage
    contributes); a rank the mesh does not hold returns ``None``.
    """
    if not mesh.member:
        return None
    s = mesh.shape[axis]
    m = x_microbatches.shape[0]
    stage = mesh.axis_index(axis)
    params = _tree_map(lambda a: a[stage], stage_params)
    buf = torch.zeros_like(x_microbatches[0])
    outs = torch.zeros_like(x_microbatches)
    ring = [(i, (i + 1) % s) for i in range(s)]
    for t in range(m + s - 1):
        # stage 0 ingests microbatch t; the others take what arrived
        cur = x_microbatches[t] if stage == 0 and t < m else buf
        # this stage's active window: t in [stage, stage + m)
        active = stage <= t < stage + m
        y = stage_fn(params, cur) if active else cur
        if stage == s - 1 and active:
            outs[t - stage] = y
        buf = ppermute(y, mesh, axis, ring)
    return broadcast(outs, mesh, axis, s - 1)
