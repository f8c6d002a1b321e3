"""Host-level channels: the serve loop's local queue and the DAE
simulator's timed FIFO, on one protocol (``ChannelBase``)."""

from repro_torch.channels.base import ChannelBase
from repro_torch.channels.local import LocalChannel
from repro_torch.channels.sim import SimChannel

__all__ = ["ChannelBase", "LocalChannel", "SimChannel"]
