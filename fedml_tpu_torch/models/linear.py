"""Linear models of the port: counterpart of ``fedml_tpu/models/linear.py``.

``LogisticRegression`` flattens its input and applies one dense layer named
``linear``; the softmax lives in the loss.  flax infers the layer's input
width at init, so here the caller names it (the hub takes it from the
dataset's shape).  Init is flax ``Dense``'s: a lecun-normal kernel (a normal
truncated at two standard deviations, std 1/sqrt(fan_in)) and a zero bias.

``MLP`` and the rest of ``linear.py`` are not ported yet (ROADMAP.md queue A,
item 4: model zoo and trainers).
"""

from __future__ import annotations

import math

import torch
from torch import nn

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


class LogisticRegression(nn.Module):
    def __init__(self, in_features: int, output_dim: int, device=None):
        super().__init__()
        self.linear = nn.Linear(in_features, output_dim, dtype=torch.float32, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x.reshape(x.shape[0], -1).float())

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            w = self.linear.weight
            std = 1.0 / math.sqrt(w.shape[1]) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            self.linear.bias.zero_()
