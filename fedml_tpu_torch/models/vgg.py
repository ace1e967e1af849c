"""VGG of the port: counterpart of ``fedml_tpu/models/vgg.py``.

SAME 3x3 convolutions with bias, named ``conv{i}`` by their index in the
depth's configuration (the max-pools take indices too, as in flax), 2x2
max-pools, a spatial mean, ``fc1`` (512) with dropout 0.5 and the
``classifier``.  NHWC input, NCHW inside (``models/cnn.py``'s ``to_nchw``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .cnn import Dropout, to_nchw
from .resnet import SameConv, flax_init

_CFG = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"],
}


class VGG(nn.Module):
    def __init__(self, num_classes: int = 10, depth: int = 16, in_channels: int = 3,
                 device=None):
        super().__init__()
        self.layers = []  # (is max-pool, conv name)
        cin = in_channels
        for i, v in enumerate(_CFG[depth]):
            if v == "M":
                self.layers.append((True, None))
            else:
                self.add_module(f"conv{i}", SameConv(cin, int(v), 3, device=device, bias=True))
                self.layers.append((False, f"conv{i}"))
                cin = int(v)
        self.fc1 = nn.Linear(cin, 512, device=device)
        self.drop = Dropout(0.5)
        self.classifier = nn.Linear(512, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_nchw(x)
        for pool, name in self.layers:
            x = F.max_pool2d(x, 2, 2) if pool else F.relu(getattr(self, name)(x))
        x = self.drop(F.relu(self.fc1(x.mean(dim=(2, 3)))))
        return self.classifier(x)

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)
