"""Cohort selection of the port (counterpart of
``fedml_tpu/core/population/policies.py``).

Every policy draws from a round-seeded local generator (never numpy's global
one), so a round's cohort is a pure function of ``(round_idx, registry
state)`` and the same clients as the JAX package's for the same registry:

* ``uniform``: the simulator's ``mt19937`` schedule, ``RandomState(round_idx)``
  drawing without replacement;
* ``stratified``: the eligible pool sorted by observed speed (the registry's
  latency EMA), cut into ``num_strata`` strata, a proportional quota drawn
  from each (largest-remainder apportionment);
* ``importance``: Gumbel-top-k on ``(num_samples + 1)^alpha`` with an
  optional staleness boost for long-unseen clients.

The cross-silo ``pcg64`` schedule comes with ROADMAP.md queue A, item 9a
(transport and cross-silo FedAvg).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .registry import ClientRegistry


def _largest_remainder(sizes: Sequence[int], k: int) -> List[int]:
    """Apportion ``k`` picks across strata proportionally to ``sizes``
    (largest-remainder method, deterministic tie-break by stratum index)."""
    sizes = np.asarray(sizes, np.float64)
    total = float(sizes.sum())
    exact = sizes * (k / total)
    quotas = np.floor(exact).astype(np.int64)
    short = int(k - quotas.sum())
    if short > 0:
        frac = exact - quotas
        order = np.lexsort((np.arange(frac.size), -frac))
        quotas[order[:short]] += 1
    # a stratum cannot owe more picks than it has members; push overflow to
    # the next stratum with headroom (deterministic left-to-right sweep)
    sizes_i = sizes.astype(np.int64)
    for i in range(quotas.size):
        over = int(quotas[i] - sizes_i[i])
        if over > 0:
            quotas[i] = sizes_i[i]
            for j in range(quotas.size):
                if j == i:
                    continue
                room = int(sizes_i[j] - quotas[j])
                if room <= 0:
                    continue
                take = min(room, over)
                quotas[j] += take
                over -= take
                if over == 0:
                    break
    return [int(q) for q in quotas]


class SelectionPolicy:
    """One cohort decision per round: ``select(round_idx, k)`` returns the
    client ids of the round's cohort, drawn only from the registry's
    eligible pool.  ``last_strata_sizes`` is set by policies that stratify,
    for the ``cohort_stats`` record."""

    name = "base"

    def __init__(self, registry: ClientRegistry):
        self.registry = registry
        self.last_strata_sizes: Optional[List[int]] = None

    def select(self, round_idx: int, k: int) -> np.ndarray:
        raise NotImplementedError


class UniformPolicy(SelectionPolicy):
    name = "uniform"

    def __init__(self, registry: ClientRegistry, rng_style: str = "mt19937"):
        super().__init__(registry)
        if rng_style != "mt19937":
            raise NotImplementedError(
                f"rng_style {rng_style!r} (the cross-silo schedule) is not ported yet "
                "(ROADMAP.md queue A, item 9a: transport and cross-silo FedAvg)")

    def select(self, round_idx: int, k: int) -> np.ndarray:
        eligible = self.registry.eligible_ids()
        if k >= eligible.size:
            return eligible.copy()
        rs = np.random.RandomState(round_idx)
        return eligible[rs.choice(eligible.size, k, replace=False)]


class StratifiedBySpeedPolicy(SelectionPolicy):
    """Sort the eligible pool by observed speed (unseen clients at the fleet
    median), cut it into ``num_strata`` contiguous strata and draw a
    proportional quota from each, so one cohort spans the speed spectrum."""

    name = "stratified"

    def __init__(self, registry: ClientRegistry, num_strata: int = 4):
        super().__init__(registry)
        self.num_strata = max(1, int(num_strata))

    def select(self, round_idx: int, k: int) -> np.ndarray:
        eligible = self.registry.eligible_ids()
        if k >= eligible.size:
            self.last_strata_sizes = [int(eligible.size)]
            return eligible.copy()
        scores = self.registry.speed_scores()[self.registry.positions(eligible)]
        order = np.argsort(scores, kind="stable")  # fastest first
        strata = [s for s in np.array_split(eligible[order], self.num_strata) if s.size]
        quotas = _largest_remainder([s.size for s in strata], k)
        rs = np.random.RandomState(round_idx)
        picks = []
        for stratum, q in zip(strata, quotas):
            if q >= stratum.size:
                picks.append(stratum)
            elif q > 0:
                picks.append(stratum[rs.choice(stratum.size, q, replace=False)])
        self.last_strata_sizes = [int(s.size) for s in strata]
        return np.sort(np.concatenate(picks))


class ImportancePolicy(SelectionPolicy):
    """Weighted sampling without replacement by Gumbel-top-k: weight
    ``(num_samples + 1)^alpha`` times an optional staleness boost that nudges
    long-unseen clients back into rotation."""

    name = "importance"

    def __init__(self, registry: ClientRegistry, alpha: float = 1.0,
                 staleness_weight: float = 0.0):
        super().__init__(registry)
        self.alpha = float(alpha)
        self.staleness_weight = float(staleness_weight)

    def select(self, round_idx: int, k: int) -> np.ndarray:
        eligible = self.registry.eligible_ids()
        if k >= eligible.size:
            return eligible.copy()
        pos = self.registry.positions(eligible)
        w = (self.registry.num_samples[pos].astype(np.float64) + 1.0) ** self.alpha
        if self.staleness_weight > 0.0:
            last = self.registry.last_seen_round[pos]
            stale = np.where(last < 0, round_idx + 1, round_idx - last)
            w = w * (1.0 + self.staleness_weight * stale / (round_idx + 1.0))
        rs = np.random.RandomState(round_idx)
        keys = np.log(w) + rs.gumbel(size=eligible.size)
        sel = np.argpartition(-keys, k - 1)[:k]
        return np.sort(eligible[sel])


def make_policy(name: str, registry: ClientRegistry, *, rng_style: str = "mt19937",
                num_strata: int = 4, importance_alpha: float = 1.0,
                importance_staleness: float = 0.0) -> SelectionPolicy:
    name = str(name or "uniform").lower()
    if name == "uniform":
        return UniformPolicy(registry, rng_style=rng_style)
    if name == "stratified":
        return StratifiedBySpeedPolicy(registry, num_strata=num_strata)
    if name == "importance":
        return ImportancePolicy(registry, alpha=importance_alpha,
                                staleness_weight=importance_staleness)
    raise ValueError(
        f"unknown selection_policy {name!r} (expected uniform|stratified|importance)")
