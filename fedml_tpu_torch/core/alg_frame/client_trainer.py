"""Client trainer ABC (counterpart of
``fedml_tpu/core/alg_frame/client_trainer.py``).

A stateless operator with ``get/set_model_params``, ``train`` and the
before/after hooks; the after-hook applies local DP noise when it is
enabled.  Model parameters are the port's ``{name: tensor}`` variables
(BatchNorm's running averages among them, flax's ``batch_stats``), and the
concrete trainers (``ml/trainer/``) are thin shells over the engine's
local-training function.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any


class ClientTrainer(ABC):
    def __init__(self, model: Any, args: Any):
        self.model = model
        self.id = 0
        self.args = args
        self.local_train_dataset = None
        self.local_test_dataset = None
        self.local_sample_number = 0

    def set_id(self, trainer_id: int) -> None:
        self.id = trainer_id

    def is_main_process(self) -> bool:
        return True

    @abstractmethod
    def get_model_params(self) -> Any:
        ...

    @abstractmethod
    def set_model_params(self, model_parameters: Any) -> None:
        ...

    def update_dataset(self, local_train_dataset, local_test_dataset, local_sample_number) -> None:
        self.local_train_dataset = local_train_dataset
        self.local_test_dataset = local_test_dataset
        self.local_sample_number = local_sample_number

    def on_before_local_training(self, train_data, device, args) -> None:
        """Hook: runs before the local epochs."""

    @abstractmethod
    def train(self, train_data, device, args) -> Any:
        ...

    def on_after_local_training(self, train_data, device, args) -> None:
        """Hook: applies LOCAL DP noise when enabled, drawn from the DP
        engine's generator in call order."""
        from ..dp.fedml_differential_privacy import FedMLDifferentialPrivacy

        dp = FedMLDifferentialPrivacy.get_instance()
        if dp.is_local_dp_enabled():
            self.set_model_params(dp.add_local_noise(self.get_model_params()))

    def test(self, test_data, device, args) -> Any:
        return None
