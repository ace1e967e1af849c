"""Graph-task ClientTrainers beyond graph classification (counterpart of
``fedml_tpu/ml/trainer/graph_trainers.py``): link prediction and multi-task
property prediction with partial labels (the SpreadGNN setting).

Both train on the classification trainer's engine with the masked-sentinel
BCE (engine loss ``linkpred`` or ``mtl_bce``; -1 marks an unlabeled pair or
task) and share one eval: a hit is ``(score > 0) == (label > 0.5)``, counted
over the labeled entries, with the summed BCE over them as the loss."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cls_trainer import ModelTrainerCLS, to_device


class _MaskedBCETrainer(ModelTrainerCLS):
    """Shared eval over the labeled entries, one forward over the split."""

    def test(self, test_data, device, args):
        x, y = test_data
        scores = self.eval_logits(x)
        y = to_device(y, scores.device).float()
        labeled = (y >= 0).float()
        labels = y.clamp_min(0.0)
        per = F.binary_cross_entropy_with_logits(scores, labels, reduction="none")
        hit = ((scores > 0) == (labels > 0.5)).float() * labeled
        loss, correct, total = torch.stack(
            [(per * labeled).sum(), hit.sum(), labeled.sum()]).tolist()
        return {"test_correct": correct, "test_loss": loss, "test_total": total}


class ModelTrainerLinkPred(_MaskedBCETrainer):
    """Link prediction: scores [B, N, N], labels {-1, 0, 1}."""

    loss_kind = "linkpred"


class ModelTrainerMTL(_MaskedBCETrainer):
    """Multi-task binary property prediction with partial labels: logits
    [B, T], labels {-1, 0, 1}."""

    loss_kind = "mtl_bce"
