"""Makespan-minimizing assignment of sampled clients to mesh slots.

Role of reference ``core/schedule/seq_train_scheduler.py`` (``DP_schedule``):
each device trains its assigned clients *sequentially*, so the round takes as
long as the heaviest device; pick the assignment minimizing that makespan.

Implementation: LPT (longest-processing-time-first) greedy — 4/3-optimal for
identical machines — plus an exchange-refinement pass that moves/swaps
clients between the heaviest and lightest slots while it improves makespan.
Costs come from a ``RuntimeEstimator`` when one has observations, else raw
sample counts (equivalent up to the fitted constants).

Output shape is TPU-static: a dense [n_dev, per_dev] id matrix + mask, the
layout consumed by the scan-over-clients in ``simulation/xla/fed_sim.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .runtime_estimate import RuntimeEstimator


class SeqTrainScheduler:
    def __init__(
        self,
        num_devices: int,
        estimator: Optional[RuntimeEstimator] = None,
        refine_iters: int = 64,
    ):
        self.num_devices = int(num_devices)
        self.estimator = estimator
        self.refine_iters = int(refine_iters)

    # -- cost model ---------------------------------------------------
    def _costs(self, client_ids: Sequence[int], sizes: Sequence[int]) -> np.ndarray:
        """Cost of each client in arbitrary-but-consistent units.

        Uses the pooled runtime model when one exists; TPU mesh slots are
        identical chips, so a single model covers all devices.  Per-device
        (heterogeneous) estimators would need a full [n_dev, n_clients] cost
        matrix and a different assignment algorithm — fall back to sample
        counts for those rather than mispredicting with device 0's fit."""
        est = self.estimator
        if est is not None and est.has_model() and est.uniform_devices:
            # Marginal cost only: the fitted intercept is whole-round fixed
            # overhead (observations are round wall times), identical across
            # assignments — charging it per client would swamp a·n and reduce
            # LPT to count-balancing.
            costs = [est.predict_marginal(0, int(s)) for s in sizes]
            if all(c is not None for c in costs):
                return np.asarray(costs, np.float64)
        return np.asarray(sizes, np.float64)

    # -- assignment ---------------------------------------------------
    def schedule(
        self, client_ids: Sequence[int], sizes: Sequence[int]
    ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Returns (ids [n_dev, per_dev], mask [n_dev, per_dev], makespan).

        ``per_dev = ceil(len(clients)/n_dev)`` — every slot gets the same
        static scan length; mask==0 rows are weight-0 padding clients."""
        client_ids = np.asarray(client_ids, np.int64)
        n = len(client_ids)
        n_dev = self.num_devices
        per_dev = max(1, -(-n // n_dev))
        costs = self._costs(client_ids, sizes)

        buckets: List[List[int]] = [[] for _ in range(n_dev)]
        loads = np.zeros(n_dev)
        # LPT: heaviest client first onto the lightest non-full slot
        for k in np.argsort(-costs):
            cap_penalty = np.where([len(b) >= per_dev for b in buckets], np.inf, 0.0)
            d = int(np.argmin(loads + cap_penalty))
            buckets[d].append(int(k))
            loads[d] += costs[k]

        self._refine(buckets, loads, costs, per_dev)

        ids = np.zeros((n_dev, per_dev), np.int32)
        mask = np.zeros((n_dev, per_dev), np.int32)
        for d, b in enumerate(buckets):
            for j, k in enumerate(b):
                ids[d, j] = client_ids[k]
                mask[d, j] = 1
        return ids, mask, float(loads.max())

    def _refine(self, buckets, loads, costs, per_dev) -> None:
        """Move/swap between argmax and argmin slots while makespan drops."""
        for _ in range(self.refine_iters):
            hi = int(np.argmax(loads))
            lo = int(np.argmin(loads))
            if hi == lo or not buckets[hi]:
                return
            gap = loads[hi] - loads[lo]
            improved = False
            # best single move hi -> lo (if lo has a free slot)
            if len(buckets[lo]) < per_dev:
                k = min(buckets[hi], key=lambda k: abs(costs[k] - gap / 2))
                if costs[k] < gap:
                    buckets[hi].remove(k)
                    buckets[lo].append(k)
                    loads[hi] -= costs[k]
                    loads[lo] += costs[k]
                    improved = True
            if not improved and buckets[lo]:
                # best swap: transfer delta = c_hi - c_lo in (0, gap)
                best = None
                for a in buckets[hi]:
                    for b in buckets[lo]:
                        delta = costs[a] - costs[b]
                        if 0 < delta < gap and (best is None or abs(delta - gap / 2) < abs(best[2] - gap / 2)):
                            best = (a, b, delta)
                if best is not None:
                    a, b, delta = best
                    buckets[hi].remove(a)
                    buckets[lo].remove(b)
                    buckets[hi].append(b)
                    buckets[lo].append(a)
                    loads[hi] -= delta
                    loads[lo] += delta
                    improved = True
            if not improved:
                return
