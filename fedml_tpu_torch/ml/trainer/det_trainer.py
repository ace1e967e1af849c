"""Object-detection ClientTrainer of the port (counterpart of
``fedml_tpu/ml/trainer/det_trainer.py``: ``box_iou``, ``ModelTrainerDET``):
training rides the engine's ``det`` loss (class CE plus 5 x the box's
smooth-L1).  Its eval, one forward over the test split, reports the summed
class CE as ``test_loss``, the correct classes as ``test_correct`` and the
mean IoU of the predicted boxes with the true ones as ``test_mean_iou``."""

from __future__ import annotations

import torch

from ..engine.train import _ce
from .cls_trainer import ModelTrainerCLS, to_device


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of [B, 4] (cx, cy, w, h) box pairs."""
    ax0, ay0 = a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2
    ax1, ay1 = a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2
    bx0, by0 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    bx1, by1 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    iw = (torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0)).clamp_min(0.0)
    ih = (torch.minimum(ay1, by1) - torch.maximum(ay0, by0)).clamp_min(0.0)
    inter = iw * ih
    union = a[:, 2] * a[:, 3] + b[:, 2] * b[:, 3] - inter
    return inter / union.clamp_min(1e-9)


class ModelTrainerDET(ModelTrainerCLS):
    loss_kind = "det"

    def test(self, test_data, device, args):
        x, y = test_data
        out = self.eval_logits(x)
        y = to_device(y, out.device).float()
        n_cls = out.shape[-1] - 4
        cls = y[:, 0].long()
        loss, correct, iou_sum = torch.stack([
            _ce(out[:, :n_cls], cls).sum(), (out[:, :n_cls].argmax(dim=-1) == cls).sum().float(),
            box_iou(out[:, n_cls:], y[:, 1:]).sum()]).tolist()
        total = float(out.shape[0])
        return {
            "test_correct": correct,  # class-accuracy count
            "test_loss": loss,
            "test_total": total,
            "test_mean_iou": iou_sum / max(total, 1.0),
        }
