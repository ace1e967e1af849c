"""Tag-prediction ClientTrainer of the port (counterpart of
``fedml_tpu/ml/trainer/tag_trainer.py``, ``ModelTrainerTAGPred``):
multi-label classification with sigmoid BCE (engine loss ``bce``) on the
classification trainer's engine.

Labels may be multi-hot [B, C] floats or class ids [B] (one-hot to C, the
width of the model's last parameter in ``ravel_pytree`` order, as the JAX
trainer reads it).  Eval, one forward over the test split, reports
per-label-position counts through the shared keys (``test_correct`` /
``test_total``; ``test_loss`` the mean BCE times the positions) and
precision, recall and F1 of the 0.5-thresholded sigmoid."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...models.convert import FlatLayout
from .cls_trainer import ModelTrainerCLS, to_device


def as_multihot(y: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[B] class ids -> one-hot [B, C] fp32; multi-hot labels as fp32."""
    if y.dim() == 1:
        return F.one_hot(y.long(), num_classes).float()
    return y.float()


class ModelTrainerTAGPred(ModelTrainerCLS):
    loss_kind = "bce"

    def _num_classes(self) -> int:
        return int(FlatLayout.of(self.variables).entries[-1][3][-1])

    def train(self, train_data, device, args, extra=None):
        x, y = train_data
        yh = as_multihot(to_device(y, self._device()), self._num_classes())
        return super().train((x, yh), device, args, extra=extra)

    def test(self, test_data, device, args):
        x, y = test_data
        logits = self.eval_logits(x)
        yh = as_multihot(to_device(y, logits.device), logits.shape[-1])
        pred = (torch.sigmoid(logits) > 0.5).float()
        bce = F.binary_cross_entropy_with_logits(logits, yh, reduction="none")
        tp, fp, fn, correct, mean_bce = torch.stack([
            (pred * yh).sum(), (pred * (1 - yh)).sum(), ((1 - pred) * yh).sum(),
            (pred == yh).float().sum(), bce.mean()]).tolist()
        precision = tp / max(tp + fp, 1.0)
        recall = tp / max(tp + fn, 1.0)
        f1 = 2 * precision * recall / max(precision + recall, 1e-12)
        n_positions = float(yh.numel())
        return {
            # shared protocol keys, all per label position, so the server's
            # correct/total and loss/total divisions stay meaningful
            "test_correct": correct,
            "test_loss": mean_bce * n_positions,
            "test_total": n_positions,
            "test_precision": precision,
            "test_recall": recall,
            "test_f1": f1,
        }
