"""Span-extraction ClientTrainer of the port (counterpart of
``fedml_tpu/ml/trainer/span_trainer.py``, ``ModelTrainerSpan``): the
start/end CE loss (engine loss ``span``) on the classification trainer's
engine; eval, one forward over the test split, reports the summed loss and
the exact-match count (both endpoints right) as ``test_correct``."""

from __future__ import annotations

import torch

from ..engine.train import span_ce_loss
from .cls_trainer import ModelTrainerCLS, to_device


class ModelTrainerSpan(ModelTrainerCLS):
    loss_kind = "span"

    def test(self, test_data, device, args):
        x, y = test_data
        logits = self.eval_logits(x)
        y = to_device(y, logits.device).long()
        _, (loss, _) = span_ce_loss(logits, y, torch.ones_like(y[:, 0], dtype=torch.float32))
        exact = ((logits[..., 0].argmax(-1) == y[:, 0])
                 & (logits[..., 1].argmax(-1) == y[:, 1])).float().sum()
        loss, correct = torch.stack([loss, exact]).tolist()
        return {"test_correct": correct,  # exact-match count
                "test_loss": loss, "test_total": float(y.shape[0])}
