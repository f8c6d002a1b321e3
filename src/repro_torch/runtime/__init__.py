"""Decoupled Access/Execute serving on the port's models, and the
fault-tolerant training loop."""

from repro_torch.runtime.straggler import StragglerEvent, StragglerMonitor
from repro_torch.runtime.train_loop import StepFailure, TrainLoopConfig, fit

__all__ = ["StragglerEvent", "StragglerMonitor", "StepFailure",
           "TrainLoopConfig", "fit"]
