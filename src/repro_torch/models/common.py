"""Shared model config and numeric primitives: the counterpart of
``repro.models.common`` for every model family of the JAX package: the
dense, MoE and early-fusion (``vlm``) decoders, with GQA or MLA
attention, the recurrent families (RWKV6, the Hymba hybrid) and the
encoder-decoder.

Parameters are ``nn.Module`` attributes kept in the JAX package's layout
(a dense weight is ``(d_in, d_out)`` and applies as ``x @ w``), so the
parity tests compare like with like and ``convert.params_from_numpy``
copies leaves without transposing.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Callable, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel import sharding as sh
from repro_torch.parallel.collectives import pmax


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """A run of ``count`` consecutive identical layers (kind 'attn':
    self-attention + MLP; 'moe': self-attention + mixture of experts;
    'hymba': parallel windowed attention + SSM, then MLP; 'hymba_global':
    the same with full attention; 'rwkv': time-mix + channel-mix; 'enc':
    bidirectional self-attention + MLP; 'xattn': causal self-attention,
    cross attention, then MLP)."""

    kind: str
    count: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                       # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # attention
    attn_kind: str = "gqa"            # gqa | mla
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None      # sliding-window size (local attn)
    # MLA (DeepSeek/MiniCPM3)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 0              # 0 -> head_dim
    v_head_dim: int = 0               # 0 -> head_dim

    # mlp
    mlp_kind: str = "swiglu"          # swiglu | relu | gelu

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    capacity_factor: float = 1.25
    first_dense_layers: int = 0       # leading dense-FFN layers (deepseek)
    pad_experts_to: int = 0           # pad expert dim for EP divisibility

    # SSM / hybrid
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0              # 0 -> d_model // 16
    global_attn_layers: Tuple[int, ...] = ()   # hymba full-attn layer ids

    # encoder-decoder (the encoder is bidirectional whatever
    # enc_bidirectional says, as in the reference, which carries the
    # field but never reads it)
    n_enc_layers: int = 0
    enc_bidirectional: bool = True

    # rwkv
    rwkv_head_dim: int = 64

    # norms / embedding
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_soft_cap: float = 0.0

    # numerics / kernels
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    kernel_mode: str = "kernel"       # kernel | ref  (JAX's "pallas" = kernel)
    attn_impl: str = "ref"            # ref (S^2) | chunked | banded (ref mode)
    attn_chunk: int = 1024
    remat: bool = True                # recompute each layer in backward
    remat_policy: str = "full"        # full | dots (save matmul outputs)
    # carried with JAX's defaults; the eager port reads neither of these
    scan_layers: bool = True          # False -> unrolled (cost-model probes)
    act_sp: bool = False              # sequence-parallel residual stream
    mesh_dp_axes: Tuple[str, ...] = ("data",)
    mesh_tp_axis: str = "model"
    # sharded paged serving sets it to the decode mesh's axis, as JAX's
    # loop does; JAX reads it only as a placement hint inside jit (no
    # effect on one device), and the port's attention does not read it
    mesh_pool_axis: Optional[str] = None

    def __post_init__(self) -> None:
        if self.kernel_mode == "pallas":
            object.__setattr__(self, "kernel_mode", "kernel")
        if self.kernel_mode not in ("kernel", "ref"):
            raise ValueError(f"kernel_mode must be 'kernel' or 'ref', got "
                             f"{self.kernel_mode!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                             f"{self.remat_policy!r}")

    @property
    def n_experts_padded(self) -> int:
        return max(self.n_experts, self.pad_experts_to)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def qk_nope(self) -> int:
        return self.qk_nope_dim or self.hd

    @property
    def v_hd(self) -> int:
        return self.v_head_dim or self.hd

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(1, self.d_model // 16)

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def layer_specs(self) -> List[LayerSpec]:
        """Consecutive homogeneous segments, as the JAX package stacks
        them (``vlm`` and ``dense`` alike: one ``attn`` segment; the
        encoder-decoder's two stacks are built by ``models/encdec.py``)."""
        if self.family == "ssm":
            return [LayerSpec("rwkv", self.n_layers)]
        if self.family == "hybrid":
            segs: List[LayerSpec] = []
            g = set(self.global_attn_layers)
            for i in range(self.n_layers):
                kind = "hymba_global" if i in g else "hymba"
                if segs and segs[-1].kind == kind:
                    segs[-1] = LayerSpec(kind, segs[-1].count + 1)
                else:
                    segs.append(LayerSpec(kind, 1))
            return segs
        if self.family == "moe":
            segs = []
            if self.first_dense_layers:
                segs.append(LayerSpec("attn", self.first_dense_layers))
            segs.append(LayerSpec("moe",
                                  self.n_layers - self.first_dense_layers))
            return segs
        return [LayerSpec("attn", self.n_layers)]


# ---------------------------------------------------------------------------
# Initializers / numeric primitives
# ---------------------------------------------------------------------------

_LEAF_HOOK: contextvars.ContextVar = contextvars.ContextVar("leaf_hook",
                                                           default=None)


@contextlib.contextmanager
def leaf_hook(fn: Callable[[torch.nn.Parameter], torch.nn.Parameter]
              ) -> Iterator[None]:
    """Within the block every leaf a model's constructor makes
    (:func:`dense_param`, :func:`vector_param`, :func:`norm_param`) is
    passed through ``fn``, in the order the constructor makes and draws
    them, and ``fn``'s parameter is the one the module keeps
    (``launch/steps.py::init_shards`` cuts each leaf to a rank's shard as
    it is drawn)."""
    token = _LEAF_HOOK.set(fn)
    try:
        yield
    finally:
        _LEAF_HOOK.reset(token)


def _leaf(p: torch.nn.Parameter) -> torch.nn.Parameter:
    fn = _LEAF_HOOK.get()
    return p if fn is None else fn(p)


def dense_param(shape: Tuple[int, ...], dtype: torch.dtype,
                device: torch.device,
                generator: Optional[torch.Generator]) -> torch.nn.Parameter:
    """A ``(..., d_in, d_out)`` weight (a stack of them for experts)
    drawn N(0, 1/d_in) in float32, as JAX's ``dense_init``, and stored
    in ``dtype``; left uninitialised without a generator (a checkpoint
    fills it).  Frozen: a train step turns gradients on."""
    if generator is None:
        w = torch.empty(shape, dtype=dtype, device=device)
    else:
        w = (torch.randn(shape, generator=generator, device=device)
             * (1.0 / math.sqrt(shape[-2]))).to(dtype)
    return _leaf(torch.nn.Parameter(w, requires_grad=False))


def vector_param(t: torch.Tensor) -> torch.nn.Parameter:
    """A leaf that is not a matrix (a mix, a decay, a bias, a gain),
    stored in float32 as JAX's ``param_dtype``; frozen as
    :func:`dense_param`."""
    return _leaf(torch.nn.Parameter(t.float().contiguous(),
                                    requires_grad=False))


def drawn(shape: Tuple[int, ...], device: torch.device,
          generator: Optional[torch.Generator], normal: bool) -> torch.Tensor:
    """Float32 draws of N(0, 1) (``normal``) or U(0, 1) from
    ``generator``; left uninitialised without one (a checkpoint fills
    them)."""
    if generator is None:
        return torch.empty(shape, device=device)
    draw = torch.randn if normal else torch.rand
    return draw(shape, generator=generator, device=device)


def norm_param(d: int, device: torch.device) -> torch.nn.Parameter:
    return _leaf(torch.nn.Parameter(torch.ones((d,), device=device),
                                    requires_grad=False))


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * g.float()).to(x.dtype)


def stream_norm(x: torch.Tensor, g: torch.Tensor, eps: float
                ) -> torch.Tensor:
    """The norm of the residual stream ``x`` as the next sublayer (or
    the head) reads it: ``rmsnorm``; on a stream a sharded step cuts
    along its tokens (``act_sp``), the norm of this rank's tokens
    gathered whole (``parallel/sharding.py::residual_stream``)."""
    return sh.stream_gather(rmsnorm(x, sh.stream_gain(g), eps))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x (..., S, D_even); positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs              # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def activation(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "relu":
        return F.relu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    if kind in ("silu", "swiglu"):
        return F.silu(x)
    raise ValueError(kind)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1, vocab_slot: int = -1
                       ) -> torch.Tensor:
    """logits (..., V); labels int; the mean negative log-likelihood over
    the labels that are not ``ignore_id``, in float32.  The max shift is
    held constant under differentiation, as JAX's ``stop_gradient``; the
    gold logit is a gather, where JAX reduces an iota mask (one nonzero
    term: the same value).

    In a sharded step the mean is over the labels of the whole batch
    (the count summed over the batch axis), and ``vocab_slot`` >= 0 says
    ``logits`` are this rank's slot of a vocab cut over ``model``: the
    max is taken over ``model`` (held constant), the sum of exps and the
    gold logit (a masked local gather) are summed over it."""
    logits = logits.float()
    mask = labels != ignore_id
    safe = torch.where(mask, labels, 0).long()
    m = logits.amax(-1).detach()
    if vocab_slot >= 0:
        m = pmax(m, sh.current_shards().mesh, "model")
        v = logits.shape[-1]
        safe = safe - vocab_slot * v
        mine = (safe >= 0) & (safe < v)
        sumexp = sh.tp_leave(torch.sum(torch.exp(logits - m[..., None]), -1))
        gold = torch.gather(logits, -1, torch.where(mine, safe, 0)[..., None])
        gold = sh.tp_leave(torch.where(mine, gold[..., 0], 0.0))
    else:
        sumexp = torch.sum(torch.exp(logits - m[..., None]), -1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    logz = torch.log(sumexp) + m
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(sh.batch_psum(mask.sum()), min=1)
