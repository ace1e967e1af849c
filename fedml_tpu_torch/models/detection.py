"""The single-object detector of the port: counterpart of
``fedml_tpu/models/detection.py`` (``TinyDetector``).

Three SAME 3x3 stride-2 convolutions (no bias; over an even side XLA pads
(0, 1), which ``models/resnet.py``'s ``SameConv`` reproduces), each with
GroupNorm of 8-channel groups (epsilon 1e-6) and a relu; the feature map is
flattened in flax's (H, W, C) order (box regression needs the spatial
position, so no pooling), then ``neck`` (64, relu), ``cls_head`` and
``box_head`` (sigmoid).  Output [B, num_classes + 4]: the class logits, then
the normalised box (cx, cy, w, h).  NHWC input, NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .cnn import flatten_nhwc, to_nchw
from .resnet import GroupNorm, SameConv, flax_init

GROUP_SIZE = 8
FEATURES = (16, 32, 64)


class TinyDetector(nn.Module):
    def __init__(self, num_classes: int = 6, in_hw=(32, 32), in_channels: int = 3,
                 device=None):
        super().__init__()
        h, w, cin = int(in_hw[0]), int(in_hw[1]), in_channels
        for i, feats in enumerate(FEATURES):
            self.add_module(f"conv{i}", SameConv(cin, feats, 3, 2, device=device))
            self.add_module(f"norm{i}", GroupNorm(feats, device=device,
                                                  num_groups=feats // GROUP_SIZE))
            h, w, cin = -(-h // 2), -(-w // 2), feats  # SAME: ceil(size / stride)
        self.neck = nn.Linear(h * w * cin, 64, device=device)
        self.cls_head = nn.Linear(64, num_classes, device=device)
        self.box_head = nn.Linear(64, 4, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_nchw(x)
        for i in range(len(FEATURES)):
            x = F.relu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(x)))
        x = F.relu(self.neck(flatten_nhwc(x)))
        return torch.cat([self.cls_head(x), torch.sigmoid(self.box_head(x))], dim=-1)

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)
