"""Semantic-segmentation ClientTrainer of the port (counterpart of
``fedml_tpu/ml/trainer/seg_trainer.py``, ``ModelTrainerSeg``): training rides
the engine's ``ce`` loss (the [B] sample mask broadcasts over the [B, H, W]
per-pixel CE).  Its eval runs the test split in batches of 64 and reports the
summed per-pixel CE as ``test_loss``, the correct pixels as
``test_correct`` over ``test_total`` pixels, and ``test_miou``, the
dataset-level mean IoU: per-class (intersection, union) counts summed over
the batches and divided once, over the classes with a nonzero union."""

from __future__ import annotations

import numpy as np
import torch

from ...models.unet import iou_counts
from ..engine.train import _ce
from .cls_trainer import ModelTrainerCLS, to_device

EVAL_BATCH = 64


def dataset_miou(inter: np.ndarray, union: np.ndarray) -> float:
    """Mean IoU over the classes present (union > 0); 0.0 when none is."""
    present = union > 0
    return float(np.mean(inter[present] / union[present])) if present.any() else 0.0


class ModelTrainerSeg(ModelTrainerCLS):
    loss_kind = "ce"

    def test(self, test_data, device, args):
        x, masks = test_data
        stats, inter, union = [], 0, 0
        for s in range(0, len(masks), EVAL_BATCH):
            logits = self.eval_logits(x[s:s + EVAL_BATCH])
            m = to_device(masks[s:s + EVAL_BATCH], logits.device).long()
            i, u = iou_counts(logits, m, logits.shape[-1])
            stats.append(torch.stack([_ce(logits, m).sum(),
                                      (logits.argmax(dim=-1) == m).sum().float()]))
            inter, union = inter + i, union + u
        loss, correct = torch.stack(stats).sum(dim=0).tolist()
        return {
            "test_correct": correct,  # correct pixels
            "test_loss": loss,
            "test_total": float(np.asarray(masks).size),  # pixels
            "test_miou": dataset_miou(inter.cpu().numpy(), union.cpu().numpy()),
        }
