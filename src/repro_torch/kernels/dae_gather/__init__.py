from repro_torch.kernels.dae_gather.ops import dae_gather
from repro_torch.kernels.dae_gather.ref import gather_ref

__all__ = ["dae_gather", "gather_ref"]
