"""Public wrapper for the grouped expert matmul: the counterpart of
``repro.kernels.grouped_matmul.ops``.

``method="kernel"`` (JAX's ``"pallas"``) runs the Hopper kernel on CUDA
tensors and its plain version on CPU tensors; ``method="ref"`` is the
oracle.  Knobs left ``None`` resolve explicit → tune cache (keyed on
(T, D, F) and x's dtype, as the reference keys them) → analytic.  The
TPU column tile ``bf`` is the kernel's column tile, 128 or 256 columns
(a smaller ``bf`` takes 128, a larger 256; default ``DEFAULT_BN``); the
TPU depth tile ``bd`` has no counterpart (the CUDA kernel streams D in
stages of its own and masks ragged edges): it is accepted (a positive
int, or ``None``) and ignored.  ``rif`` left ``None`` resolves to
``plan_rif`` inside the kernel wrapper.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import (cdiv, check_ignored, refuse_autograd,
                                        tuned_knobs)
from repro_torch.kernels.grouped_matmul import kernel as _k
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   block_expert: torch.Tensor, *, bt: int = 128,
                   bf: Optional[int] = None, bd: Optional[int] = None,
                   block_rows: Optional[torch.Tensor] = None,
                   rif: Optional[int] = None,
                   method: str = "kernel") -> torch.Tensor:
    """Expert-grouped GEMM: x (T, D) with tokens sorted by expert and
    grouped into ``bt``-token blocks; block_expert (ceil(T/bt),) is the
    expert of each token block; w (E, D, F).  Returns (T, F).

    A tail block (``T % bt != 0``) keeps its block's expert; ``T == 0``
    (every expert group empty) short-circuits to an empty (0, F) result;
    experts no block routes to are never read.  ``block_rows`` optionally
    counts the real rows at the head of each block (the rest must be
    zero rows, as the MoE dispatch pads them), so the kernel can skip
    them and blocks without any."""
    if method not in ("kernel", "ref"):
        raise ValueError(f"unknown method {method!r}")
    check_ignored(bf=bf, bd=bd)
    t = x.shape[0]
    f = w.shape[2]
    nblk = cdiv(t, bt)
    if block_expert.shape[0] != nblk:
        raise ValueError(
            f"block_expert has {block_expert.shape[0]} entries for "
            f"{nblk} token blocks (T={t}, bt={bt})")
    if t == 0:
        return torch.zeros((0, f), dtype=x.dtype, device=x.device)
    if method == "ref":
        return grouped_matmul_ref(x, w, block_expert, bt,
                                  block_rows=block_rows)
    refuse_autograd("grouped_matmul", x, w)
    if bf is None or bd is None or rif is None:
        knobs = tuned_knobs("grouped_matmul", (t, x.shape[1], f), x.dtype,
                            x.device, bf=(bf, _k.DEFAULT_BN),
                            rif=(rif, None))
        bf, rif = knobs["bf"], knobs["rif"]
    return _k.gmm(x.contiguous(), w.contiguous(),
                  block_expert.to(torch.int32).contiguous(), bt=bt,
                  block_rows=None if block_rows is None
                  else block_rows.to(torch.int32).contiguous(), rif=rif,
                  _bn=128 if bf <= 128 else 256)
