"""PyTorch/CUDA port of the DAE4HLS reproduction for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: its layout follows
``repro`` module by module, plain tensor code is PyTorch, and every
Pallas kernel on a ported path is a CUDA C++ kernel for ``sm_90a``
(``csrc/``) with its plain PyTorch version beside it.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.  The package
imports neither ``jax`` nor anything of ``repro``.
"""
