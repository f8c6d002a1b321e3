"""Host side of the explicit-decoupling ring.

The counterpart of ``repro.kernels.ring``.  On the TPU the ring is a
``rif``-deep VMEM scratch with one DMA semaphore per slot, and
``ring_step`` lets it span grid steps because TPU scratch persists
across them.  CUDA shared memory does not persist across blocks, so on
Hopper the ring lives in ``csrc/ring.cuh`` as a ``rif``-stage
shared-memory ring filled with ``cp.async`` (one commit group per
request), and one CTA owns a whole request stream: the prologue requests
``0 .. min(rif, n)``; the steady state waits on ``k``, executes, then
requests ``k + rif``; the drain is implicit.  What stays on the host is
the depth arithmetic the wrappers share.
"""

from __future__ import annotations

__all__ = ["clamp_rif", "MAX_RIF"]

# ring.cuh waits with ``cp.async.wait_group rif - 1``, an immediate
# operand; its dispatch covers depths up to this bound.
MAX_RIF = 16


def clamp_rif(rif: int, n: int) -> int:
    """Clamp a requested ring depth to the request-stream length: a ring
    deeper than the stream never fills (its tail slots would hold copies
    no response ever waits on), and depth 0 cannot make progress."""
    return max(1, min(rif, n))
