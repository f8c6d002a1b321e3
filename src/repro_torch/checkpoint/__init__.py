"""Checkpoints in the JAX package's npz layout: the counterpart of
``repro.checkpoint``."""

from repro_torch.checkpoint.io import load_pytree, save_pytree
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["save_pytree", "load_pytree", "CheckpointManager"]
