"""Graph property regression ClientTrainer (counterpart of
``fedml_tpu/ml/trainer/reg_trainer.py``, ``ModelTrainerReg``): trains on the
engine's ``mse`` loss.  Its eval, one forward over the test split, reports
the sum of the per-example mean squared errors as ``test_loss``, a hit when
an example's largest absolute error is below ``regression_tolerance``
(default 0.5) as ``test_correct``, and ``test_rmse``."""

from __future__ import annotations

import math

import torch

from .cls_trainer import ModelTrainerCLS, to_device


class ModelTrainerReg(ModelTrainerCLS):
    loss_kind = "mse"
    tolerance = 0.5  # |err| < tol counts as a hit (test_correct)

    def __init__(self, model, args, grad_hook=None):
        super().__init__(model, args, grad_hook=grad_hook)
        self.tol = float(getattr(args, "regression_tolerance", self.tolerance))

    def test(self, test_data, device, args):
        x, y = test_data
        pred = self.eval_logits(x)
        y = to_device(y, pred.device).float().reshape(pred.shape)
        axes = tuple(range(1, pred.dim()))
        err = torch.square(pred - y).mean(dim=axes)
        hits = (pred - y).abs().amax(dim=axes) < self.tol
        loss, correct = torch.stack([err.sum(), hits.float().sum()]).tolist()
        total = float(pred.shape[0])
        return {
            "test_correct": correct,
            "test_loss": loss,
            "test_total": total,
            "test_rmse": math.sqrt(loss / max(total, 1.0)),
        }
