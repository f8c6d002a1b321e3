from repro_torch.kernels.dae_spmv.ops import csr_to_bsr, dae_spmv
from repro_torch.kernels.dae_spmv.ref import bsr_spmv_ref, spmv_ref

__all__ = ["dae_spmv", "csr_to_bsr", "spmv_ref", "bsr_spmv_ref"]
