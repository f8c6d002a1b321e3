from repro_torch.kernels.dae_chase.ops import batched_searchsorted, hash_lookup
from repro_torch.kernels.dae_chase.ref import hash_lookup_ref, searchsorted_ref

__all__ = ["batched_searchsorted", "hash_lookup", "searchsorted_ref",
           "hash_lookup_ref"]
