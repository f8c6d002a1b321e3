"""AdamW and learning-rate schedules: the counterpart of
``repro.optim``."""

from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamW", "OptState", "warmup_cosine"]
