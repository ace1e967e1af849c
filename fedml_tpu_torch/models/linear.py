"""Linear models of the port: counterpart of ``fedml_tpu/models/linear.py``.

``LogisticRegression`` flattens its input and applies one dense layer named
``linear``; the softmax lives in the loss.  flax infers the layer's input
width at init, so here the caller names it (the hub takes it from the
dataset's shape).  Init is flax ``Dense``'s: a lecun-normal kernel (a normal
truncated at two standard deviations, std 1/sqrt(fan_in)) and a zero bias.

``MLP`` is the two-hidden-layer perceptron of the tabular tasks: flattened
input, ``Dense_0`` and ``Dense_1`` (``hidden``, relu each) and ``Dense_2``,
the flax auto-names, with the same init.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .resnet import flax_init

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


class MLP(nn.Module):
    def __init__(self, in_features: int, output_dim: int, hidden: int = 128, device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, hidden, device=device)
        self.Dense_2 = nn.Linear(hidden, output_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1).float()))
        return self.Dense_2(torch.relu(self.Dense_1(x)))

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)
