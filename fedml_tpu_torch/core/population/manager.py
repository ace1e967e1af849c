"""Population manager of the port: the simulator surface of
``fedml_tpu/core/population/manager.py``, ``select`` for the round's cohort.
The per-round accounting (``observe_round``, ``history``) comes with the
pacing and cross-silo rounds that read it."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .policies import make_policy
from .registry import ClientRegistry


class PopulationManager:
    def __init__(self, registry: ClientRegistry, policy):
        self.registry = registry
        self.policy = policy

    @classmethod
    def from_args(cls, args, client_ids: Sequence[int],
                  rng_style: str = "mt19937") -> "PopulationManager":
        registry = ClientRegistry(client_ids)
        blocklist = getattr(args, "population_blocklist", None)
        if blocklist:
            registry.blocklist(list(blocklist))
        policy = make_policy(getattr(args, "selection_policy", "uniform"), registry,
                             rng_style=rng_style)
        return cls(registry, policy)

    def select(self, round_idx: int, k: int) -> np.ndarray:
        """Policy draw only — no accounting (the simulator sampling seam)."""
        return self.policy.select(int(round_idx), int(k))
