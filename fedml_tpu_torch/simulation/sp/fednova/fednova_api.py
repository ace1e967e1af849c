"""FedNova of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/fednova/fednova_api.py``): normalized averaging
(Wang et al.).

Each client's cumulative update is normalized by its local step count tau_i
before averaging: ``w <- w - tau_eff * sum_i p_i * d_i``, ``d_i = (w - w_i) /
max(tau_i, 1)``, ``tau_eff = sum_i p_i * tau_i``.  tau_i is the trainer's
``last_result.steps`` (the real steps taken), recorded right after each
client's training and reset with each round's draw.

The taus are paired with the updates by object identity before the
before-stage hooks, as the JAX package pairs them: an update those hooks
return as it was (krum's and multi-krum's picks) keeps its tau, one they
rebuild (norm clipping, a model attack) takes tau 1.0.  The aggregate is
this rule, not the aggregator's, so an on-aggregation defense is refused.
"""

from __future__ import annotations

from typing import Any, List, Tuple

from ....core.aggregate import tree_scale, tree_sum
from ..fedavg.fedavg_api import ON_DEFENSE, FedAvgAPI


class FedNovaAPI(FedAvgAPI):
    SKIPPED_HOOKS = (ON_DEFENSE,)

    def _collect_tau(self) -> float:
        res = getattr(self.trainer, "last_result", None)
        return float(res.steps) if res is not None else 1.0

    def _client_sampling(self, round_idx: int) -> List[int]:
        self._round_taus: List[float] = []
        return super()._client_sampling(round_idx)

    def _train_client(self, client, w_global) -> Any:
        out = super()._train_client(client, w_global)
        self._round_taus.append(self._collect_tau())
        return out

    def server_update(self, w_locals: List[Tuple[float, Any]]) -> Any:
        # taus in collection order == w_locals order; paired before the
        # before-stage hooks, so a filtered subset keeps each survivor's tau
        tau_by_id = {id(w): t for (_, w), t in zip(w_locals, self._round_taus)}
        w_locals = self.aggregator.on_before_aggregation(w_locals)
        taus = [tau_by_id.get(id(w), 1.0) for _, w in w_locals]
        total_n = sum(n for n, _ in w_locals)
        ps = [n / total_n for n, _ in w_locals]
        tau_eff = sum(p * t for p, t in zip(ps, taus))
        normalized = []
        for (_, w_i), p, tau in zip(w_locals, ps, taus):
            d_i = {k: (g - w_i[k]) / max(tau, 1.0) for k, g in self.w_global.items()}
            normalized.append(tree_scale(d_i, p))
        d = tree_sum(normalized)
        new_global = {k: g - tau_eff * d[k] for k, g in self.w_global.items()}
        return self.aggregator.on_after_aggregation(new_global)
