from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

__all__ = ["grouped_matmul", "grouped_matmul_ref"]
