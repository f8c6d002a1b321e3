"""Hand-written Hopper kernels and their plain PyTorch versions.

Each family follows ``repro.kernels``: ``ref.py`` (the oracle),
``kernel.py`` (the counted wrapper over the CUDA source in ``csrc/``,
with its plain version beside it) and ``ops.py`` (the public dispatcher).
"""
