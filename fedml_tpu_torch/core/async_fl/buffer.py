"""The update buffer of buffered-async FL (counterpart of
``fedml_tpu/core/async_fl/buffer.py``; the ``sp`` simulator's FedBuff parks
each accepted client update here and flushes once ``capacity`` accrue).

Instead of closing a round on quorum, the async server parks every
accepted client delta here, tagged with the global-model *version* the
client trained against, and flushes the whole buffer through the
aggregation once ``capacity`` deltas accrue.  Two properties matter for
correctness:

* **one delta per sender per cycle**: ``add`` raises on a duplicate
  sender;
* **canonical drain order**: ``drain`` returns entries sorted by
  ``(version, sender)``, so the flush aggregate is a left-to-right fold
  over a deterministic list.  This is what makes flushes bit-reproducible
  given an arrival schedule, and what lines async up with the sync
  participant order for the FedAvg-equivalence guarantee.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from .staleness import _check_policy, staleness_weight


def _approx_nbytes(obj: Any) -> int:
    """Tensor-leaf byte count of a ``{name: tensor}`` tree (numpy arrays
    count too; scalars and other leaves count as 0)."""
    if torch.is_tensor(obj):
        return obj.numel() * obj.element_size()
    nb = getattr(obj, "nbytes", None)
    if nb is not None:
        try:
            return int(nb)
        except (TypeError, ValueError):
            return 0
    if isinstance(obj, dict):
        return sum(_approx_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_approx_nbytes(v) for v in obj)
    return 0


@dataclasses.dataclass(frozen=True)
class BufferedDelta:
    """One accepted client update awaiting a flush."""
    sender: int
    params: Any
    n_samples: float
    version: int    # global-model version the client trained against
    staleness: int  # flush version minus trained version, fixed at accept


class UpdateBuffer:
    """Fixed-capacity accumulator of :class:`BufferedDelta`."""

    def __init__(self, capacity: int, policy: str = "constant",
                 alpha: float = 0.5, hinge_b: int = 4):
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"async_buffer_size must be >= 1, got {capacity}")
        self.capacity = capacity
        self.policy = _check_policy(policy)
        self.alpha = float(alpha)
        self.hinge_b = int(hinge_b)
        self._entries: Dict[int, BufferedDelta] = {}
        self._bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def occupancy(self) -> int:
        return len(self._entries)

    def ready(self) -> bool:
        return len(self._entries) >= self.capacity

    def senders(self) -> List[int]:
        return sorted(self._entries)

    @property
    def approx_bytes(self) -> int:
        """Approximate bytes of the buffered payloads (tensor leaves only)."""
        return self._bytes

    def add(self, sender: int, params: Any, n_samples: float, version: int,
            staleness: int) -> int:
        """Park one delta; returns the new occupancy.  A duplicate sender is
        a caller bug."""
        sender = int(sender)
        if sender in self._entries:
            raise ValueError(
                f"sender {sender} already buffered this cycle: a same-cycle "
                "re-upload must be dropped before it gets here")
        if int(staleness) < 0:
            raise ValueError(
                f"negative staleness {staleness} for sender {sender} "
                f"(version {version}): version tags may never lead the server")
        self._entries[sender] = BufferedDelta(
            sender=sender, params=params, n_samples=float(n_samples),
            version=int(version), staleness=int(staleness))
        self._bytes += _approx_nbytes(params)
        return len(self._entries)

    def drain(self) -> List[BufferedDelta]:
        """Remove and return every entry in canonical ``(version, sender)``
        order — the deterministic fold order for the flush aggregate."""
        entries = sorted(self._entries.values(),
                         key=lambda e: (e.version, e.sender))
        self._entries.clear()
        self._bytes = 0
        return entries

    def weighted(self, entries: List[BufferedDelta]) -> List[Tuple[float, Any]]:
        """The ``(weight, params)`` list the aggregation consumes:
        ``weight = n_samples * staleness_weight(policy, s)``.  Under the
        ``constant`` policy the multiplier is exactly ``1.0``, so the list
        is bit-identical to the sync path's ``(n_samples, params)``."""
        return [
            (e.n_samples * staleness_weight(
                self.policy, e.staleness, alpha=self.alpha,
                hinge_b=self.hinge_b), e.params)
            for e in entries
        ]

    @staticmethod
    def staleness_stats(entries: List[BufferedDelta]) -> Dict[str, float]:
        """Per-flush staleness distribution (min, mean, max)."""
        if not entries:
            return {"staleness_min": 0.0, "staleness_mean": 0.0,
                    "staleness_max": 0.0}
        vals = [e.staleness for e in entries]
        return {
            "staleness_min": float(min(vals)),
            "staleness_mean": round(float(sum(vals)) / len(vals), 4),
            "staleness_max": float(max(vals)),
        }
