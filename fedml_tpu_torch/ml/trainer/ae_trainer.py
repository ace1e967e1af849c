"""Anomaly-detection ClientTrainer of the port (counterpart of
``fedml_tpu/ml/trainer/ae_trainer.py``, ``ModelTrainerAE``): clients train
an autoencoder to reconstruct their benign local traffic; the eval flags
anomalies by reconstruction error.

Training rides the engine's ``mse`` loss with the inputs as targets (the
``recon`` train split carries y = x; a 1-D y or none is replaced by the
flattened inputs).  The eval thresholds the per-row mean squared error at
median + 3 * 1.4826 * MAD of the whole test set's errors, in one forward
(a batched eval would give each batch its own median), and reports the
rows whose flag it matches as ``test_correct``, the errors' sum as
``test_loss`` and the share of flagged rows it catches as
``test_anomaly_recall``.  The median is ``jnp.median``'s: the mean of the
two middle values of an even count, where ``torch.median`` returns the
lower one.
"""

from __future__ import annotations

import numpy as np
import torch

from .cls_trainer import ModelTrainerCLS, to_device


def median(v: torch.Tensor) -> torch.Tensor:
    """The median of a 1-D tensor as ``jnp.median`` takes it: the middle
    value of an odd count, the mean of the two middle values of an even one."""
    s = torch.sort(v).values
    k = (s.numel() - 1) // 2
    return s[k] if s.numel() % 2 else (s[k] + s[k + 1]) * 0.5


class ModelTrainerAE(ModelTrainerCLS):
    loss_kind = "mse"

    def train(self, train_data, device, args, extra=None):
        x, y = train_data
        if y is None or np.ndim(y) == 1:  # the targets are the inputs
            y = x.reshape(len(x), -1)
        return super().train((x, y), device, args, extra=extra)

    def test(self, test_data, device, args):
        x, flags = test_data
        recon = self.eval_logits(x)
        flat = to_device(x, recon.device).float().reshape(recon.shape[0], -1)
        err = torch.square(recon - flat).mean(dim=-1)
        med = median(err)
        thresh = med + 3.0 * 1.4826 * median((err - med).abs())
        pred = (err > thresh).float()
        flags = to_device(flags, recon.device).float()
        correct = (pred == flags).float().sum()
        recall = (pred * flags).sum() / flags.sum().clamp_min(1.0)
        loss, correct, recall = torch.stack([err.sum(), correct, recall]).tolist()
        return {
            "test_correct": correct,
            "test_loss": loss,
            "test_total": float(recon.shape[0]),
            "test_anomaly_recall": recall,
        }
