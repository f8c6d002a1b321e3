from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_decode,
                                                     flash_decode_paged)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     decode_chunk_ref,
                                                     decode_ref)

__all__ = ["flash_attention", "flash_decode", "flash_decode_paged",
           "attention_ref", "decode_chunk_ref", "decode_ref"]
