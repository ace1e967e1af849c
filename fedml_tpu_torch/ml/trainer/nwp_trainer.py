"""Next-word-prediction ClientTrainer (counterpart of
``fedml_tpu/ml/trainer/nwp_trainer.py``, ``ModelTrainerNWP``).

The engine already treats [B, L] integer labels per token (masked CE and
token accuracy, ``ml/engine/train.py``), so the NWP trainer is the
classification trainer; the subclass keeps the factory's shape and is the
anchor for NWP-specific extensions."""

from __future__ import annotations

from .cls_trainer import ModelTrainerCLS


class ModelTrainerNWP(ModelTrainerCLS):
    pass
