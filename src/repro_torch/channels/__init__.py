"""Host-level channels: the serve loop's local queue, the DAE
simulator's timed FIFO and the sharded serve loop's ring of device rows
over a mesh axis, on one protocol (``ChannelBase``)."""

from repro_torch.channels.base import ChannelBase
from repro_torch.channels.local import LocalChannel
from repro_torch.channels.mesh import MeshChannel
from repro_torch.channels.sim import SimChannel

__all__ = ["ChannelBase", "LocalChannel", "SimChannel", "MeshChannel"]
