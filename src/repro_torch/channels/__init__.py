"""Host-level channels joining the serve loop's engines."""

from repro_torch.channels.base import ChannelBase
from repro_torch.channels.local import LocalChannel

__all__ = ["ChannelBase", "LocalChannel"]
