"""Distribution: the sharding rules (DP/FSDP/TP/EP/SP) and placement on
an engine mesh's device.  Pipeline stages, expert dispatch and gradient
compression wait for the collective half of multi-device serving."""

from repro_torch.parallel.sharding import (ShardingRules, batch_sharding,
                                           cache_shardings, param_shardings)

__all__ = ["ShardingRules", "param_shardings", "batch_sharding",
           "cache_shardings"]
