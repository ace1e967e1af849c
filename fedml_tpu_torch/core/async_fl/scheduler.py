"""The simulator's virtual arrival queue (counterpart of
``VirtualArrivalQueue`` in ``fedml_tpu/core/async_fl/scheduler.py``).

The buffered-async mode of the round simulator pushes each client's
virtual finish time and pops reports in time order; ties are broken by push
order, so the schedule is a function of the seed alone.
"""

from __future__ import annotations

import heapq
from typing import List, Tuple


class VirtualArrivalQueue:
    """Deterministic virtual-time report schedule (simulator surface)."""

    def __init__(self):
        self._heap: List[Tuple[float, int, int]] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def push(self, client_id: int, finish_time: float) -> None:
        heapq.heappush(self._heap,
                       (float(finish_time), self._seq, int(client_id)))
        self._seq += 1

    def peek_time(self) -> float:
        return self._heap[0][0]

    def pop(self) -> Tuple[float, int]:
        """``(finish_time, client_id)`` of the next virtual report."""
        t, _, cid = heapq.heappop(self._heap)
        return t, cid

    def clients(self) -> List[int]:
        """The client ids currently in flight (sorted, for set checks)."""
        return sorted(cid for _, _, cid in self._heap)
