"""Privacy budget accountant.

Parity with reference ``core/dp/budget_accountant.py``: tracks per-round
(epsilon, delta) spends under basic and advanced composition and raises when
the configured budget is exhausted.
"""

from __future__ import annotations

import math
from typing import List, Tuple


class BudgetAccountant:
    def __init__(self, epsilon: float = float("inf"), delta: float = 1.0):
        self.epsilon_budget = float(epsilon)
        self.delta_budget = float(delta)
        self._spends: List[Tuple[float, float]] = []

    def spend(self, epsilon: float, delta: float = 0.0) -> None:
        eps_total, delta_total = self.total()
        if eps_total + epsilon > self.epsilon_budget + 1e-12 or delta_total + delta > self.delta_budget + 1e-12:
            raise RuntimeError(
                f"privacy budget exhausted: spent=({eps_total:.4g},{delta_total:.4g}) "
                f"request=({epsilon:.4g},{delta:.4g}) budget=({self.epsilon_budget:.4g},{self.delta_budget:.4g})"
            )
        self._spends.append((float(epsilon), float(delta)))

    def total(self) -> Tuple[float, float]:
        """Basic (sequential) composition."""
        return (sum(e for e, _ in self._spends), sum(d for _, d in self._spends))

    def total_advanced(self, delta_slack: float = 1e-6) -> Tuple[float, float]:
        """Advanced composition (Dwork-Roth Thm 3.20) for k homogeneous spends."""
        if not self._spends:
            return (0.0, 0.0)
        k = len(self._spends)
        eps = max(e for e, _ in self._spends)
        delta = sum(d for _, d in self._spends) + delta_slack
        eps_adv = eps * math.sqrt(2.0 * k * math.log(1.0 / delta_slack)) + k * eps * (math.exp(eps) - 1.0)
        return (min(eps_adv, k * eps), delta)

    @property
    def remaining(self) -> Tuple[float, float]:
        e, d = self.total()
        return (self.epsilon_budget - e, self.delta_budget - d)

    def __len__(self) -> int:
        return len(self._spends)
