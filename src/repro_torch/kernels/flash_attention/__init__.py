from repro_torch.kernels.flash_attention.ops import (flash_decode,
                                                     flash_decode_paged)
from repro_torch.kernels.flash_attention.ref import (decode_chunk_ref,
                                                     decode_ref)

__all__ = ["flash_decode", "flash_decode_paged", "decode_chunk_ref",
           "decode_ref"]
