"""Dense autoencoder of the IoT anomaly-detection family: counterpart of
``fedml_tpu/models/autoencoder.py`` (``AutoEncoder``).

A symmetric dense stack with a bottleneck that reconstructs benign traffic;
anomalies are flagged by their reconstruction error
(``ml/trainer/ae_trainer.py``).  The input is flattened to [B, D]; four
dense layers named as flax names them (``enc1``, ``enc2``, ``dec1``,
``dec2``) with a relu after each of the first three, so
``models/convert.py`` maps their leaves by its one rule.  Init is flax
``Dense``'s (``resnet.flax_init``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import flax_init


class AutoEncoder(nn.Module):
    """x [B, ...] -> reconstruction [B, feat_dim]."""

    def __init__(self, feat_dim: int, hidden: int = 32, bottleneck: int = 8, device=None):
        super().__init__()
        self.enc1 = nn.Linear(feat_dim, hidden, device=device)
        self.enc2 = nn.Linear(hidden, bottleneck, device=device)
        self.dec1 = nn.Linear(bottleneck, hidden, device=device)
        self.dec2 = nn.Linear(hidden, feat_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.enc1(x.reshape(x.shape[0], -1).float()))
        z = F.relu(self.enc2(h))
        return self.dec2(F.relu(self.dec1(z)))

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)
