"""Server aggregator base class with the security and DP hooks (counterpart
of ``fedml_tpu/core/alg_frame/server_aggregator.py``).

``on_before_aggregation`` runs the attacker's injection (Byzantine
simulation), then the defender's filtering; ``aggregate`` delegates to the
defender when one is on, else to ``FedMLAggOperator.agg`` (the
sample-weighted mean, or the plain sum in the ``_seq`` modes);
``on_after_aggregation`` runs the defender's post-processing, then adds
central DP noise when enabled.  Updates are ``(n, {name: tensor})`` pairs.
The ``sp`` simulator (``simulation/sp/fedavg/fedavg_api.py``) calls these
hooks between collection and aggregation; the round simulator keeps the
global variables here and evaluates them, and runs the stacked forms of the
same hooks on the card (``simulation/xla/fed_sim.py``).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List, Tuple

from ..aggregate import FedMLAggOperator
from ..dp.fedml_differential_privacy import FedMLDifferentialPrivacy
from ..security.fedml_attacker import FedMLAttacker
from ..security.fedml_defender import FedMLDefender


class ServerAggregator(ABC):
    def __init__(self, model: Any, args: Any):
        self.model = model
        self.id = 0
        self.args = args

    def set_id(self, aggregator_id: int) -> None:
        self.id = aggregator_id

    @abstractmethod
    def get_model_params(self) -> Any:
        ...

    @abstractmethod
    def set_model_params(self, model_parameters: Any) -> None:
        ...

    def on_before_aggregation(
        self, raw_client_model_or_grad_list: List[Tuple[float, Any]]
    ) -> List[Tuple[float, Any]]:
        attacker = FedMLAttacker.get_instance()
        if attacker.is_model_attack():
            raw_client_model_or_grad_list = attacker.attack_model(
                raw_client_grad_list=raw_client_model_or_grad_list,
                extra_auxiliary_info=self.get_model_params(),
            )
        defender = FedMLDefender.get_instance()
        if defender.is_defense_enabled():
            raw_client_model_or_grad_list = defender.defend_before_aggregation(
                raw_client_grad_list=raw_client_model_or_grad_list,
                extra_auxiliary_info=self.get_model_params(),
            )
        return raw_client_model_or_grad_list

    def aggregate(self, raw_client_model_or_grad_list: List[Tuple[float, Any]]) -> Any:
        defender = FedMLDefender.get_instance()
        if defender.is_defense_enabled():
            return defender.defend_on_aggregation(
                raw_client_grad_list=raw_client_model_or_grad_list,
                base_aggregation_func=FedMLAggOperator.agg,
                extra_auxiliary_info=self.get_model_params(),
            )
        return FedMLAggOperator.agg(self.args, raw_client_model_or_grad_list)

    def on_after_aggregation(self, aggregated_model_or_grad: Any) -> Any:
        defender = FedMLDefender.get_instance()
        if defender.is_defense_enabled():
            aggregated_model_or_grad = defender.defend_after_aggregation(aggregated_model_or_grad)
        dp = FedMLDifferentialPrivacy.get_instance()
        if dp.is_global_dp_enabled():
            aggregated_model_or_grad = dp.add_global_noise(aggregated_model_or_grad)
        return aggregated_model_or_grad

    @abstractmethod
    def test(self, test_data, device, args) -> Any:
        ...
