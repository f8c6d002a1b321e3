"""Distribution: the sharding rules (DP/FSDP/TP/EP/SP) and placement on
an engine mesh, the collectives along a rank mesh's axes, pipeline
stages, expert-parallel dispatch and gradient compression."""

from repro_torch.parallel.compress import (compressed_grad_mean,
                                           compressed_psum, dequantize,
                                           quantize)
from repro_torch.parallel.ep_dispatch import ep_moe_reference, make_ep_moe
from repro_torch.parallel.pp import pipeline_forward
from repro_torch.parallel.sharding import (ShardingRules, batch_sharding,
                                           cache_shardings, param_shardings)

__all__ = ["ShardingRules", "param_shardings", "batch_sharding",
           "cache_shardings", "quantize", "dequantize", "compressed_psum",
           "compressed_grad_mean", "pipeline_forward", "ep_moe_reference",
           "make_ep_moe"]
