"""Buffered asynchronous FL of the port: the staleness policies, the update
buffer and the simulator's virtual arrival queue.  The message-plane server,
its clocks and ``StalenessScheduler`` are not ported yet (ROADMAP.md queue A,
item 9c: async and population accounting)."""

from .buffer import BufferedDelta, UpdateBuffer
from .scheduler import VirtualArrivalQueue
from .staleness import ASYNC_STALENESS_POLICIES, staleness_weight, staleness_weights

__all__ = ["ASYNC_STALENESS_POLICIES", "BufferedDelta", "UpdateBuffer", "VirtualArrivalQueue",
           "staleness_weight", "staleness_weights"]
