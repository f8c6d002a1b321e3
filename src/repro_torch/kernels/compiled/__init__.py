"""The ring kernels ``repro_torch.compile`` lowers programs onto: the
counterpart of ``repro.kernels.compiled``.

Shape-generic, like the reference's: the compiler instantiates them from
an elaborated :class:`~repro_torch.compile.ir.DaeIR` instead of a human
writing a kernel per workload.
"""

from repro_torch.kernels.compiled.kernel import (chase_library, ring_chase,
                                                 ring_deref, ring_gather)

__all__ = ["ring_gather", "ring_deref", "ring_chase", "chase_library"]
