"""Buffered asynchronous FL of the port: the staleness policies and the
simulator's virtual arrival queue.  The message-plane server, its buffer and
``StalenessScheduler`` are not ported yet (ROADMAP.md queue A, item 9c: async and
population accounting)."""

from .scheduler import VirtualArrivalQueue
from .staleness import ASYNC_STALENESS_POLICIES, staleness_weight, staleness_weights

__all__ = ["ASYNC_STALENESS_POLICIES", "VirtualArrivalQueue", "staleness_weight",
           "staleness_weights"]
