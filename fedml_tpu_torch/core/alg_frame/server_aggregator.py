"""Server aggregator base class of the port (counterpart of
``fedml_tpu/core/alg_frame/server_aggregator.py``).

The simulator keeps the global variables on the aggregator and asks it to
evaluate them; the round's weighted mean is the algorithm's server step
(``simulation/xla/algorithms.py``).  The JAX base class's aggregation hooks,
where the attack, defense and central-DP layers plug in, come with those
layers: ``fedml_tpu_torch.init`` refuses configs that switch them on.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any


class ServerAggregator(ABC):
    def __init__(self, model: Any, args: Any):
        self.model = model
        self.args = args

    @abstractmethod
    def get_model_params(self) -> Any:
        ...

    @abstractmethod
    def set_model_params(self, model_parameters: Any) -> None:
        ...

    @abstractmethod
    def test(self, test_data, device, args) -> Any:
        ...
