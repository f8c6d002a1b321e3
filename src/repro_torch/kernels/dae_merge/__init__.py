from repro_torch.kernels.dae_merge.ops import merge_sort, merge_sorted
from repro_torch.kernels.dae_merge.ref import merge_ref, sort_ref

__all__ = ["merge_sorted", "merge_sort", "merge_ref", "sort_ref"]
