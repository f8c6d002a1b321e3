"""Training data: the counterpart of ``repro.data``."""

from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import SyntheticLM

__all__ = ["SyntheticLM", "PrefetchLoader"]
