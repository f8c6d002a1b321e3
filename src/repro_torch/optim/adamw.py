"""AdamW with global-norm clipping: the counterpart of
``repro.optim.adamw``.

The state is ``OptState(step, m, v)`` as in JAX: ``step`` a 0-d int32
tensor, ``m`` and ``v`` float32 tensors keyed by parameter name
(:class:`NamedParams`), so a checkpoint lays them out as JAX lays out its
moment trees.  ``step`` lives on the host, so the bias corrections and
the learning rate are host scalars computed in float32 as JAX computes
them, and no update waits for the card; the clip scale stays on the
device.  ``update`` works one tensor at a time and in place: a
``torch._foreach_*`` pass over the whole tree would allocate temporaries
for every leaf at once, which at a few billion float32 parameters does
not fit beside the state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.models.convert import NamedParams, named

Tree = Union[torch.nn.Module, Mapping[str, torch.Tensor]]


class OptState(NamedTuple):
    step: torch.Tensor
    m: NamedParams
    v: NamedParams


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params: Tree) -> OptState:
        """Zero float32 moments beside every parameter; step 0."""
        leaves = named(params)
        return OptState(
            step=torch.zeros((), dtype=torch.int32),
            m=NamedParams((k, torch.zeros_like(p, dtype=torch.float32))
                          for k, p in leaves.items()),
            v=NamedParams((k, torch.zeros_like(p, dtype=torch.float32))
                          for k, p in leaves.items()))

    def _lr(self, step: torch.Tensor) -> float:
        return float(self.lr(step) if callable(self.lr) else self.lr)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: OptState,
               params: Tree) -> Tuple[Tree, OptState, torch.Tensor]:
        """One AdamW step: clip ``grads`` (keyed by parameter name) to
        global norm ``clip_norm``, update the moments and the parameters
        in place; returns (params, the new state, the unclipped global
        norm, a 0-d float32 tensor on the parameters' device)."""
        leaves = named(params)
        # a reduction, not torch.dot: a BLAS dot sums tens of millions of
        # float32 squares in a few long chains (3e-5 relative on the CPU)
        sq = 0.0
        for k in leaves:
            g = grads[k].float()
            sq = sq + torch.sum(g * g)
        gnorm = torch.sqrt(sq + 1e-16)
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / gnorm, max=1.0)

        step = state.step.cpu() + 1
        b1, b2 = self.b1, self.b2
        stepf = step.float()
        bc1 = float(1 - torch.pow(b1, stepf))
        bc2 = float(1 - torch.pow(b2, stepf))
        lr = self._lr(step)
        for k, p in leaves.items():
            g = grads[k].float()
            if scale is not None:
                g = g * scale
            m, v = state.m[k], state.v[k]
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            del g
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            upd.add_(p, alpha=self.weight_decay)
            p.sub_(upd, alpha=lr)
            del upd
        return params, OptState(step=step, m=state.m, v=state.v), gnorm
