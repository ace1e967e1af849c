"""Centralized (non-federated) baselines (counterpart of ``fedml_tpu/centralized``)."""

from .centralized_trainer import CentralizedTrainer

__all__ = ["CentralizedTrainer"]
