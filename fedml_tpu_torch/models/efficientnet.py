"""EfficientNet of the port: counterpart of ``fedml_tpu/models/efficientnet.py``
(the compact B0-style net of hub key ``efficientnet``).

``MBConv``: a 1x1 expansion (skipped at expand 1), a depthwise SAME
convolution (stride 2 over an even side pads (0, 1), as XLA does), a
``SqueezeExcite``, a 1x1 projection and a residual where the shapes agree.
GroupNorm of ``min(8, c)`` groups (flax ``num_groups=min(8, c)``, epsilon
1e-6) after every convolution.  Module names are the flax auto-names
(``Conv_0``, ``GroupNorm_1``, ``MBConv_3``, ``SqueezeExcite_0``, ...).  NHWC
input, NCHW inside.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .cnn import to_nchw
from .resnet import GroupNorm, SameConv, flax_init


def _gn(c: int, device) -> GroupNorm:
    return GroupNorm(c, device=device, num_groups=min(8, c))


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, ratio: int = 4, device=None):
        super().__init__()
        hidden = max(channels // ratio, 4)
        self.Dense_0 = nn.Linear(channels, hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.Dense_0(x.mean(dim=(2, 3))))
        s = torch.sigmoid(self.Dense_1(s))
        return x * s[:, :, None, None]


class MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, expand: int = 4, stride: int = 1,
                 kernel: int = 3, device=None):
        super().__init__()
        mid = in_ch * expand
        convs, norms = [], []
        if expand != 1:
            convs.append(SameConv(in_ch, mid, 1, device=device))
            norms.append(_gn(mid, device))
        convs.append(SameConv(mid, mid, kernel, stride, device=device, groups=mid))
        norms.append(_gn(mid, device))
        convs.append(SameConv(mid, out_ch, 1, device=device))
        norms.append(_gn(out_ch, device))
        for i, (conv, norm) in enumerate(zip(convs, norms)):
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"GroupNorm_{i}", norm)
        self.n_convs = len(convs)
        self.SqueezeExcite_0 = SqueezeExcite(mid, device=device)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_convs - 1):  # the expansion and the depthwise
            h = F.relu(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(h)))
        h = self.SqueezeExcite_0(h)
        last = self.n_convs - 1
        h = getattr(self, f"GroupNorm_{last}")(getattr(self, f"Conv_{last}")(h))
        return h + x if self.residual else h


class EfficientNet(nn.Module):
    """(out_ch, expand, stride, repeats) stages; default ~B0-lite."""

    def __init__(self, num_classes: int,
                 stages: Sequence[Tuple[int, int, int, int]] = (
                     (16, 1, 1, 1), (24, 4, 2, 2), (40, 4, 2, 2), (80, 4, 2, 2), (112, 4, 1, 1)),
                 stem: int = 32, in_channels: int = 3, device=None):
        super().__init__()
        self.Conv_0 = SameConv(in_channels, stem, 3, device=device)
        self.GroupNorm_0 = _gn(stem, device)
        cin, j = stem, 0
        for out_ch, expand, stride, repeats in stages:
            for r in range(repeats):
                self.add_module(f"MBConv_{j}", MBConv(cin, out_ch, expand,
                                                      stride if r == 0 else 1, device=device))
                cin, j = out_ch, j + 1
        self.n_blocks = j
        self.Conv_1 = SameConv(cin, 192, 1, device=device)
        self.GroupNorm_1 = _gn(192, device)
        self.Dense_0 = nn.Linear(192, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.GroupNorm_0(self.Conv_0(to_nchw(x))))
        for j in range(self.n_blocks):
            h = getattr(self, f"MBConv_{j}")(h)
        h = F.relu(self.GroupNorm_1(self.Conv_1(h)))
        return self.Dense_0(h.mean(dim=(2, 3)))

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)
