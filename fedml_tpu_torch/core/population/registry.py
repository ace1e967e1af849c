"""Fleet registry of the port (counterpart of
``fedml_tpu/core/population/registry.py``): the simulator-side columns.

Array-backed, as the JAX registry is, so it holds up at the round
simulator's fleet sizes: every counter is a numpy column indexed by registry
position, and the bulk updates the simulators make once a round
(:meth:`note_invited`, :meth:`note_reports`, :meth:`note_failures`) are one
vectorized op each.  The latency EMA (alpha 0.3, the first observation taken
as is) feeds the stratified policy; ``num_samples`` and ``last_seen_round``
feed the importance policy.  The per-client ``RuntimeEstimator`` of
``core/schedule`` is in place for the per-report path, which feeds it.

The message plane's writers (``note_report``, which also feeds the
estimator, ``note_rejected_late``, ``note_rejoin``, ``absorb_comm_stats``),
the estimator's reader ``predicted_seconds`` and the persisted state columns
come with it (ROADMAP.md queue A, items 9a-9c); until then the
``rejected_late`` and ``rejoins`` columns stay zero.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..schedule.runtime_estimate import RuntimeEstimator


class ClientRegistry:
    """Per-client metadata columns, keyed by client id (``arange(N)`` for the
    simulators; ids need not be contiguous: lookups go through a position
    map with an identity fast path)."""

    def __init__(self, client_ids: Sequence[int],
                 num_samples: Optional[Sequence[int]] = None):
        self.ids = np.asarray(list(client_ids), dtype=np.int64)
        if self.ids.ndim != 1 or self.ids.size == 0:
            raise ValueError("client_ids must be a non-empty 1-D sequence")
        if np.unique(self.ids).size != self.ids.size:
            raise ValueError("client_ids must be unique")
        n = self.ids.size
        self._identity = bool(np.array_equal(self.ids, np.arange(n)))
        self._pos: Optional[Dict[int, int]] = (
            None if self._identity else {int(c): i for i, c in enumerate(self.ids)})
        self.num_samples = (np.zeros(n, np.int64) if num_samples is None
                            else np.asarray(list(num_samples), np.int64))
        if self.num_samples.shape != (n,):
            raise ValueError("num_samples must align with client_ids")
        self.invites = np.zeros(n, np.int64)
        self.reports = np.zeros(n, np.int64)
        self.failures = np.zeros(n, np.int64)       # invited, never reported
        self.rejected_late = np.zeros(n, np.int64)  # the message plane's (9a)
        self.rejoins = np.zeros(n, np.int64)        # the message plane's (9a)
        self.last_seen_round = np.full(n, -1, np.int64)
        # EMA of observed round seconds (0 until the first report)
        self.ema_seconds = np.zeros(n, np.float64)
        self._has_obs = np.zeros(n, bool)
        self._blocked = np.zeros(n, bool)
        self._ema_alpha = 0.3
        # per-client linear runtime model t ~ a*n_samples + b
        self.estimator = RuntimeEstimator(num_devices=n, uniform_devices=False)

    def __len__(self) -> int:
        return int(self.ids.size)

    def positions(self, client_ids) -> np.ndarray:
        arr = np.asarray(client_ids, np.int64).reshape(-1)
        if self._identity:
            return arr
        return np.fromiter((self._pos[int(c)] for c in arr), np.int64, arr.size)

    def blocklist(self, client_ids) -> None:
        self._blocked[self.positions(client_ids)] = True

    def eligible_ids(self) -> np.ndarray:
        """Ids a policy may draw from (registry order, blocklist excluded)."""
        return self.ids[~self._blocked]

    def eligible_count(self) -> int:
        return int((~self._blocked).sum())

    # -- per-round accounting (vectorized) ----------------------------------
    def note_invited(self, client_ids, round_idx: int) -> None:
        self.invites[self.positions(client_ids)] += 1

    def note_reports(self, client_ids, round_idx: int,
                     seconds: Optional[float] = None) -> None:
        """Bulk report mark for a whole cohort (the simulator path)."""
        pos = self.positions(client_ids)
        self.reports[pos] += 1
        self.last_seen_round[pos] = int(round_idx)
        if seconds is not None:
            self._observe_seconds(pos, float(seconds))

    def _observe_seconds(self, pos: np.ndarray, seconds: float) -> None:
        a = self._ema_alpha
        fresh = ~self._has_obs[pos]
        ema = self.ema_seconds[pos]
        self.ema_seconds[pos] = np.where(fresh, seconds, (1 - a) * ema + a * seconds)
        self._has_obs[pos] = True

    def note_failures(self, client_ids, round_idx: int) -> None:
        """Invited-but-missing at round close (vectorized)."""
        self.failures[self.positions(client_ids)] += 1

    # -- derived signals -----------------------------------------------------
    def speed_scores(self) -> np.ndarray:
        """Per-client observed seconds (lower = faster); clients never seen
        get the fleet median so they sort into the middle stratum."""
        scores = self.ema_seconds.copy()
        if self._has_obs.any():
            scores[~self._has_obs] = float(np.median(scores[self._has_obs]))
        return scores

    def snapshot(self) -> Dict[str, int]:
        """Fleet-level totals for the ``cohort_stats`` record."""
        return {
            "fleet": int(self.ids.size),
            "eligible": self.eligible_count(),
            "invited_total": int(self.invites.sum()),
            "reported_total": int(self.reports.sum()),
            "failures_total": int(self.failures.sum()),
            "rejected_late_total": int(self.rejected_late.sum()),
            "rejoins_total": int(self.rejoins.sum()),
        }
