"""Population manager of the port: the simulator surface of
``fedml_tpu/core/population/manager.py``.

``select`` is the round's policy draw; ``observe_round`` records a whole
synchronous round after it ran (everyone sampled was invited and
reported), one vectorized registry update per counter, and appends the
round's ``cohort_stats`` record to ``history``.  The records are JAX's, less
its ``obs`` counters and its ``mlops`` emission, which is a no-op unless
``using_mlops`` (refused by the port): both come with ROADMAP.md queue A,
item 9d.  The message plane's incremental surface (``invite``,
``note_report``, ``quorum``, ``close_round``) comes with item 9a.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .pacer import RoundPacer
from .policies import SelectionPolicy, make_policy
from .registry import ClientRegistry


class PopulationManager:
    def __init__(self, registry: ClientRegistry, policy: SelectionPolicy,
                 pacer: Optional[RoundPacer] = None):
        self.registry = registry
        self.policy = policy
        self.pacer = pacer if pacer is not None else RoundPacer()
        self._target_k = 0
        self.history: List[Dict[str, Any]] = []

    @classmethod
    def from_args(cls, args, client_ids: Sequence[int],
                  num_samples: Optional[Sequence[int]] = None,
                  rng_style: str = "mt19937") -> "PopulationManager":
        registry = ClientRegistry(client_ids, num_samples=num_samples)
        blocklist = getattr(args, "population_blocklist", None)
        if blocklist:
            registry.blocklist(list(blocklist))
        policy = make_policy(
            getattr(args, "selection_policy", "uniform"), registry, rng_style=rng_style,
            num_strata=int(getattr(args, "population_strata", 4) or 4),
            importance_alpha=float(getattr(args, "importance_alpha", 1.0) or 1.0),
            importance_staleness=float(getattr(args, "importance_staleness", 0.0) or 0.0))
        return cls(registry, policy, pacer=RoundPacer.from_args(args))

    def select(self, round_idx: int, k: int) -> np.ndarray:
        """Policy draw only — no accounting (the simulator sampling seam)."""
        return self.policy.select(int(round_idx), int(k))

    def observe_round(self, round_idx: int, invited_ids, reported_ids=None,
                      seconds: Optional[float] = None,
                      reason: str = "complete") -> Dict[str, Any]:
        """Record a whole synchronous round in one shot: everyone in
        ``invited_ids`` was invited; ``reported_ids`` (default: all of them)
        reported."""
        inv = np.asarray(invited_ids, np.int64).reshape(-1)
        rep = inv if reported_ids is None else np.asarray(reported_ids, np.int64).reshape(-1)
        r = int(round_idx)
        self.registry.note_invited(inv, r)
        self.registry.note_reports(rep, r, seconds=seconds)
        missing = np.setdiff1d(inv, rep)
        if missing.size:
            self.registry.note_failures(missing, r)
        self._target_k = int(rep.size)
        return self._stats(r, int(inv.size), int(rep.size), int(missing.size), 0, reason,
                           seconds)

    def _stats(self, round_idx: int, invited: int, reported: int, failed: int,
               rejected_late: int, reason: str, seconds: Optional[float]) -> Dict[str, Any]:
        stats: Dict[str, Any] = {
            "round_idx": int(round_idx),
            "policy": self.policy.name,
            "target_k": int(self._target_k),
            "invited": invited,
            "reported": reported,
            "failed": failed,
            "rejected_late": rejected_late,
            "quorum": self.pacer.quorum_for(self._target_k, invited or self._target_k),
            "overcommit": self.pacer.overcommit,
            "close_reason": str(reason),
        }
        if seconds is not None:
            stats["round_seconds"] = round(float(seconds), 4)
        if self.policy.last_strata_sizes is not None:
            stats["strata_sizes"] = list(self.policy.last_strata_sizes)
        stats.update(self.registry.snapshot())
        self.history.append(stats)
        return stats
