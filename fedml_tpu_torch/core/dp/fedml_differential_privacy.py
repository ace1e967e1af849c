"""Singleton DP engine gating central (cdp) and local (ldp) noise
(counterpart of ``fedml_tpu/core/dp/fedml_differential_privacy.py``).

Enabled by ``enable_dp`` with ``dp_type`` in {cdp, ldp} and
``mechanism_type`` in {gaussian, laplace}: central noise is added to the
global variables after the server step, local noise to each client's
variables after its last step.  The engine's own draws (``add_noise``,
central DP) come in turn from one generator per device, seeded from
``random_seed + 7919`` as the JAX key is; the simulator's local DP draws
from a generator per client (``ml.engine.train.post_train_generator``) and
accounts here with ``spend_budget``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ...utils.rng import seeded_generator
from .budget_accountant import BudgetAccountant
from .mechanisms import Laplace, create_mechanism

DP_TYPE_CENTRAL = "cdp"
DP_TYPE_LOCAL = "ldp"
DP_SALT = 7919


class FedMLDifferentialPrivacy:
    _instance: Optional["FedMLDifferentialPrivacy"] = None

    def __init__(self):
        self.is_dp_enabled = False
        self.dp_type: Optional[str] = None
        self.mechanism = None
        self.accountant: Optional[BudgetAccountant] = None
        self.epsilon = None
        self.delta = None
        self._seed = DP_SALT
        self._gens: Dict[str, torch.Generator] = {}

    @classmethod
    def get_instance(cls) -> "FedMLDifferentialPrivacy":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def init(self, args: Any) -> None:
        if not getattr(args, "enable_dp", False):
            self.is_dp_enabled = False
            return
        self.is_dp_enabled = True
        self.dp_type = str(getattr(args, "dp_type", DP_TYPE_CENTRAL)).lower().strip()
        if self.dp_type not in (DP_TYPE_CENTRAL, DP_TYPE_LOCAL):
            raise ValueError(f"dp_type must be 'cdp' or 'ldp', got {self.dp_type!r}")
        self.epsilon = float(getattr(args, "epsilon", 1.0))
        self.delta = float(getattr(args, "delta", 1e-5))
        sensitivity = float(getattr(args, "sensitivity", 1.0))
        mechanism_type = str(getattr(args, "mechanism_type", "gaussian")).lower()
        self.mechanism = create_mechanism(mechanism_type, self.epsilon, self.delta, sensitivity)
        budget = getattr(args, "privacy_budget", None)
        if budget is None:
            self.accountant = BudgetAccountant(float("inf"), 1.0)
        elif isinstance(budget, (int, float)):
            self.accountant = BudgetAccountant(float(budget), 1.0)
        elif isinstance(budget, (list, tuple)) and len(budget) == 2:
            self.accountant = BudgetAccountant(float(budget[0]), float(budget[1]))
        else:
            raise ValueError(
                f"privacy_budget must be a scalar epsilon or (epsilon, delta) pair, got {budget!r}"
            )
        self._seed = int(getattr(args, "random_seed", 0)) + DP_SALT
        self._gens = {}

    def is_local_dp_enabled(self) -> bool:
        return self.is_dp_enabled and self.dp_type == DP_TYPE_LOCAL

    def is_global_dp_enabled(self) -> bool:
        return self.is_dp_enabled and self.dp_type == DP_TYPE_CENTRAL

    def generator(self, device) -> torch.Generator:
        """The engine's generator on ``device``'s type, made at first use."""
        kind = torch.device(device).type
        if kind not in self._gens:
            self._gens[kind] = seeded_generator((self._seed,), device)
        return self._gens[kind]

    def _spend(self, times: int) -> None:
        # Laplace is pure epsilon-DP: it never charges delta
        delta = 0.0 if isinstance(self.mechanism, Laplace) else self.delta
        for _ in range(int(times)):
            self.accountant.spend(self.epsilon, delta)

    def add_noise(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.mechanism is None:
            raise RuntimeError("DP engine not initialized")
        if self.accountant is not None:
            self._spend(1)
        device = next(iter(tree.values())).device
        return self.mechanism.add_noise(tree, self.generator(device))

    def add_local_noise(self, local_grad):
        return self.add_noise(local_grad)

    def noise_scale(self) -> float:
        """The mechanism's calibrated noise scale (Gaussian sigma, Laplace b)."""
        if self.mechanism is None:
            return 0.0
        return float(getattr(self.mechanism, "sigma", getattr(self.mechanism, "scale", 0.0)))

    def spend_budget(self, times: int = 1) -> None:
        """Account ``times`` mechanism applications without noising, for the
        simulator's local DP, which noises each client through its own
        generator."""
        if self.accountant is None:
            return
        self._spend(times)

    def add_global_noise(self, global_model):
        return self.add_noise(global_model)
