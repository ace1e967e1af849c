"""The FedGKT model pair of the port: counterpart of
``fedml_tpu/models/gkt.py`` (``GKTClientNet``, ``GKTServerNet``).

* ``GKTClientNet``, the edge extractor: a SAME 3x3 convolution, a 3x3
  stride-2 one (its pads are (0, 1) at an even size, ``resnet._same_pads``)
  and one residual block, every convolution with bias and followed by
  GroupNorm of ``min(8, c)`` groups (epsilon 1e-6); the block's input is
  added before its last relu.  It returns (features [B, H/2, W/2, width]
  NHWC, logits of a dense layer on the features' mean over H and W).
* ``GKTServerNet``, the server tower: a SAME 3x3 convolution over the
  client's features and ``blocks`` residual blocks of the same shape, the
  mean over H and W, a dense layer.

NHWC at the interfaces, NCHW inside.  The modules carry flax's auto-names
(``Conv_{i}``, ``GroupNorm_{i}`` in call order, ``Dense_0``), so
``models/convert.py`` maps their leaves by its one rule.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .cnn import to_nchw
from .resnet import GroupNorm, SameConv, flax_init


def _gn(c: int, device) -> GroupNorm:
    return GroupNorm(c, device=device, num_groups=min(8, c))


class GKTClientNet(nn.Module):
    def __init__(self, num_classes: int = 10, width: int = 32, in_channels: int = 3,
                 device=None):
        super().__init__()
        self.width = int(width)
        self.Conv_0 = SameConv(in_channels, width, 3, device=device, bias=True)
        self.Conv_1 = SameConv(width, width, 3, 2, device=device, bias=True)
        self.Conv_2 = SameConv(width, width, 3, device=device, bias=True)
        self.Conv_3 = SameConv(width, width, 3, device=device, bias=True)
        for i in range(4):
            self.add_module(f"GroupNorm_{i}", _gn(width, device))
        self.Dense_0 = nn.Linear(width, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = F.relu(self.GroupNorm_0(self.Conv_0(to_nchw(x))))
        h = F.relu(self.GroupNorm_1(self.Conv_1(h)))
        r = F.relu(self.GroupNorm_2(self.Conv_2(h)))
        features = F.relu(self.GroupNorm_3(self.Conv_3(r)) + h)
        logits = self.Dense_0(features.mean(dim=(2, 3)))
        return features.permute(0, 2, 3, 1), logits  # NHWC features

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)


class GKTServerNet(nn.Module):
    def __init__(self, num_classes: int = 10, width: int = 64, blocks: int = 3,
                 in_channels: int = 32, device=None):
        super().__init__()
        self.blocks = int(blocks)
        self.Conv_0 = SameConv(in_channels, width, 3, device=device, bias=True)
        self.GroupNorm_0 = _gn(width, device)
        for i in range(1, 2 * self.blocks + 1):
            self.add_module(f"Conv_{i}", SameConv(width, width, 3, device=device, bias=True))
            self.add_module(f"GroupNorm_{i}", _gn(width, device))
        self.Dense_0 = nn.Linear(width, num_classes, device=device)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.GroupNorm_0(self.Conv_0(to_nchw(features))))
        for b in range(self.blocks):
            i = 2 * b + 1
            r = F.relu(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(h)))
            r = getattr(self, f"GroupNorm_{i + 1}")(getattr(self, f"Conv_{i + 1}")(r))
            h = F.relu(r + h)
        return self.Dense_0(h.mean(dim=(2, 3)))

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)
