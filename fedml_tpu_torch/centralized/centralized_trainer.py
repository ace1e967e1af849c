"""Centralized baseline trainer (counterpart of
``fedml_tpu/centralized/centralized_trainer.py``): the same model trained on
the pooled data with the same engine, trainer and server aggregator, so a
federated run has its upper-bound comparison inside one framework.

It runs ``comm_round * epochs`` passes of the trainer over the pooled
training set, each with ``round_idx`` set to its index (a distinct shuffle
each), and evaluates after each.  It runs on the card unless the config sets
``device_args.device_type: cpu``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

from ..data.data_loader import load_centralized
from ..device import fp32_matmul, get_device
from ..ml.aggregator.aggregator_creator import create_server_aggregator
from ..ml.engine.train import init_variables
from ..ml.trainer.trainer_creator import create_model_trainer

logger = logging.getLogger(__name__)


class CentralizedTrainer:
    def __init__(self, args, model=None):
        self.args = args
        self.data = load_centralized(args)
        if model is None:
            from ..models import hub

            model = hub.create(args, self.data["class_num"])
        self.module = model
        self.device = get_device(args)
        self.variables = init_variables(model, self.device,
                                        seed=int(getattr(args, "random_seed", 0)))
        self.trainer = create_model_trainer(model, args)
        self.aggregator = create_server_aggregator(model, args)

    def train(self) -> Dict[str, Any]:
        with fp32_matmul():
            return self._train()

    def _train(self) -> Dict[str, Any]:
        epochs_total = int(getattr(self.args, "comm_round", 1)) * int(
            getattr(self.args, "epochs", 1))
        x, y = self.data["x_train"], self.data["y_train"]
        self.trainer.set_model_params(self.variables)
        last: Dict[str, Any] = {}
        for epoch in range(epochs_total):
            self.trainer.round_idx = epoch  # a distinct shuffle each epoch
            self.trainer.train((x, y), self.device, self.args)
            last = self.test(epoch)
        self.variables = self.trainer.get_model_params()
        return last

    def test(self, epoch: int) -> Dict[str, Any]:
        self.aggregator.set_model_params(self.trainer.get_model_params())
        stats = self.aggregator.test((self.data["x_test"], self.data["y_test"]), self.device,
                                     self.args)
        out = {
            "epoch": epoch,
            "test_acc": round(stats["test_correct"] / max(stats["test_total"], 1.0), 4),
            "test_loss": round(stats["test_loss"] / max(stats["test_total"], 1.0), 4),
        }
        logger.info("centralized eval: %s", out)
        return out
