"""Seq2seq ClientTrainer of the port (counterpart of
``fedml_tpu/ml/trainer/s2s_trainer.py``, ``ModelTrainerS2S``): causal-LM
teacher forcing over the packed [src | SEP | tgt] sequence, the loss masked
to the target positions (engine loss ``s2s``).

Eval is one forward over the whole test split (on the card: K1 once a
layer) and reports masked token accuracy (``test_correct`` /
``test_total``), the summed target-token CE, and ``test_exact_match``, the
share of sequences whose every target token is right."""

from __future__ import annotations

import torch

from ..engine.train import seq2seq_ce_loss
from .cls_trainer import ModelTrainerCLS, to_device


class ModelTrainerS2S(ModelTrainerCLS):
    loss_kind = "s2s"

    def test(self, test_data, device, args):
        x, y = test_data
        logits = self.eval_logits(x)
        y = to_device(y, logits.device).long()
        _, (loss, _) = seq2seq_ce_loss(
            logits, y, torch.ones((y.shape[0],), dtype=torch.float32, device=y.device))
        target = y >= 0
        total = target.float().sum()
        hit = logits.argmax(-1) == y.clamp_min(0)
        correct = (hit & target).float().sum()
        exact = (hit | ~target).all(dim=-1).float().sum()
        loss, correct, total, exact = torch.stack([loss, correct, total, exact]).tolist()
        return {
            "test_correct": correct,
            "test_loss": loss,
            "test_total": total,
            # a rate, not a count (as the JAX trainer reports it)
            "test_exact_match": exact / max(float(len(y)), 1.0),
        }
