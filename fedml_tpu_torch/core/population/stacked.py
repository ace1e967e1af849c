"""Stacked cohort selection of the port: a copy of
``fedml_tpu/core/population/stacked.py``, every round's cohort in ONE
vectorized draw.

The XLA Parrot simulator's fleet is 10^5-10^6 VIRTUAL clients; a per-round
Python-level ``choice`` over that pool is host work on the round's critical
path.  This path draws the whole run's schedule up front as one
``(rounds, n_total)`` key matrix and one ``argpartition`` per axis —
no Python loop over clients or rounds.

Uniform cohorts take the k SMALLEST of iid uniform keys per row (an
unordered uniform k-subset); weighted cohorts use Gumbel-top-k
(``log w + Gumbel`` noise, the exponential-race trick), which samples
without replacement proportional to ``w``.  Blocklisted clients get a
``+inf`` key and can never be drawn.

Determinism: one ``RandomState(seed)`` generates the whole matrix, so the
schedule is a pure function of ``(seed, n_total, k, rounds, weights)``.
This is a DIFFERENT schedule from the per-round legacy draw (which reseeds
per round) — it is the scale surface, opt-in via ``population_stacked``,
not the parity surface.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def stacked_cohorts(n_total: int, k: int, rounds: int, seed: int = 0,
                    weights: Optional[Sequence[float]] = None,
                    blocked: Optional[Sequence[int]] = None) -> np.ndarray:
    """Return a ``(rounds, k)`` int64 matrix; row r is round r's cohort,
    sorted by draw priority (stable, deterministic)."""
    n_total, k, rounds = int(n_total), int(k), int(rounds)
    if not (0 < k <= n_total):
        raise ValueError(f"need 0 < k <= n_total (k={k}, n_total={n_total})")
    if rounds <= 0:
        raise ValueError(f"rounds must be > 0 (got {rounds})")
    blocked_arr = None
    if blocked is not None:
        blocked_arr = np.asarray(list(blocked), np.int64)
        if blocked_arr.size and k > n_total - np.unique(blocked_arr).size:
            raise ValueError("blocklist leaves fewer than k eligible clients")
    rs = np.random.RandomState(int(seed))
    if weights is None:
        keys = rs.random_sample((rounds, n_total))
    else:
        w = np.asarray(list(weights), np.float64)
        if w.shape != (n_total,):
            raise ValueError("weights must have length n_total")
        if (w < 0).any() or not (w > 0).any():
            raise ValueError("weights must be >= 0 with at least one > 0")
        logw = np.where(w > 0, np.log(np.maximum(w, 1e-300)), -np.inf)
        # take the k smallest of -(log w + Gumbel) == the k largest Gumbel keys
        keys = -(logw[None, :] + rs.gumbel(size=(rounds, n_total)))
    if blocked_arr is not None and blocked_arr.size:
        keys[:, blocked_arr] = np.inf
    idx = np.argpartition(keys, k - 1, axis=1)[:, :k]
    # canonical within-row order: by key, tie-broken by client id
    part_keys = np.take_along_axis(keys, idx, axis=1)
    order = np.lexsort((idx, part_keys), axis=1)
    return np.take_along_axis(idx, order, axis=1).astype(np.int64)
