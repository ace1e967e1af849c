"""The MobileNet family of the port: counterpart of
``fedml_tpu/models/mobilenet.py`` (``MobileNetV1``, ``MobileNetV3Small``).

GroupNorm of 8-channel groups (flax ``group_size=8``, epsilon 1e-6) after
every convolution; depthwise convolutions are grouped convolutions, one
group a channel (flax ``feature_group_count``).  Every SAME convolution
pads as XLA does: a stride-2 window over an even side puts the odd pad at
the end ((0, 1) at k 3, (1, 2) at k 5), where ``nn.Conv2d(padding=k//2)``
would shift every output pixel (``models/resnet.py``'s ``SameConv``).
Module names are the flax ones (``block{i}``, ``dw``, ``pw``, ``Conv_0``,
``_SEBlock_0``, ...), so ``models/convert.py`` carries the leaves by name.
``hard_sigmoid`` and ``hard_swish`` are jax's: relu6(x + 3) / 6 and x times
it.  NHWC input, NCHW inside.

BatchNorm (``norm="bn"``) is not ported (ROADMAP.md queue A, item 4: model
zoo and trainers, with BatchNorm).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .cnn import to_nchw
from .resnet import GroupNorm, SameConv, _check_norm, flax_init

GROUP_SIZE = 8


def _gn(channels: int, device) -> GroupNorm:
    return GroupNorm(channels, device=device, num_groups=channels // GROUP_SIZE)


class _DWSeparable(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int, device=None):
        super().__init__()
        self.dw = SameConv(cin, cin, 3, stride, device=device, groups=cin)
        self.dw_norm = _gn(cin, device)
        self.pw = SameConv(cin, filters, 1, device=device)
        self.pw_norm = _gn(filters, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.dw_norm(self.dw(x)))
        return F.relu(self.pw_norm(self.pw(x)))


class MobileNetV1(nn.Module):
    def __init__(self, num_classes: int = 10, width: float = 1.0, norm: str = "gn",
                 small_images: bool = True, in_channels: int = 3, device=None):
        super().__init__()
        _check_norm(norm)
        w = lambda c: max(8, int(c * width))  # noqa: E731
        self.conv_init = SameConv(in_channels, w(32), 3, 1 if small_images else 2,
                                  device=device)
        self.norm_init = _gn(w(32), device)
        cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
               (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1)]
        cin = w(32)
        for i, (c, s) in enumerate(cfg):
            self.add_module(f"block{i}", _DWSeparable(cin, w(c), s, device))
            cin = w(c)
        self.n_blocks = len(cfg)
        self.classifier = nn.Linear(cin, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm_init(self.conv_init(to_nchw(x))))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        return self.classifier(x.mean(dim=(2, 3)))

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)


class _SEBlock(nn.Module):
    def __init__(self, channels: int, reduce: int = 4, device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, max(channels // reduce, 8), device=device)
        self.Dense_1 = nn.Linear(max(channels // reduce, 8), channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.Dense_0(x.mean(dim=(2, 3))))
        s = F.hardsigmoid(self.Dense_1(s))
        return x * s[:, :, None, None]


class _MBV3Block(nn.Module):
    def __init__(self, cin: int, expand: int, filters: int, kernel: int, stride: int,
                 use_se: bool, act: str, device=None):
        super().__init__()
        self.act = F.relu if act == "relu" else F.hardswish
        self.Conv_0 = SameConv(cin, expand, 1, device=device)
        self.expand_norm = _gn(expand, device)
        self.Conv_1 = SameConv(expand, expand, kernel, stride, device=device, groups=expand)
        self.dw_norm = _gn(expand, device)
        self.use_se = use_se
        if use_se:
            self._SEBlock_0 = _SEBlock(expand, device=device)
        self.Conv_2 = SameConv(expand, filters, 1, device=device)
        self.project_norm = _gn(filters, device)
        self.residual = stride == 1 and cin == filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.expand_norm(self.Conv_0(x)))
        h = self.act(self.dw_norm(self.Conv_1(h)))
        if self.use_se:
            h = self._SEBlock_0(h)
        h = self.project_norm(self.Conv_2(h))
        return h + x if self.residual else h


class MobileNetV3Small(nn.Module):
    def __init__(self, num_classes: int = 10, norm: str = "gn", small_images: bool = True,
                 in_channels: int = 3, device=None):
        super().__init__()
        _check_norm(norm)
        self.Conv_0 = SameConv(in_channels, 16, 3, 1 if small_images else 2, device=device)
        self.norm_init = _gn(16, device)
        cfg = [  # expand, filters, kernel, stride, se, act
            (16, 16, 3, 2, True, "relu"),
            (72, 24, 3, 2, False, "relu"),
            (88, 24, 3, 1, False, "relu"),
            (96, 40, 5, 2, True, "hswish"),
            (240, 40, 5, 1, True, "hswish"),
            (240, 40, 5, 1, True, "hswish"),
            (120, 48, 5, 1, True, "hswish"),
            (144, 48, 5, 1, True, "hswish"),
            (288, 96, 5, 2, True, "hswish"),
            (576, 96, 5, 1, True, "hswish"),
            (576, 96, 5, 1, True, "hswish"),
        ]
        cin = 16
        for i, (e, f, k, s, se, act) in enumerate(cfg):
            self.add_module(f"block{i}", _MBV3Block(cin, e, f, k, s, se, act, device))
            cin = f
        self.n_blocks = len(cfg)
        self.Conv_1 = SameConv(cin, 576, 1, device=device)
        self.norm_head = _gn(576, device)
        self.Dense_0 = nn.Linear(576, 1024, device=device)
        self.classifier = nn.Linear(1024, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.hardswish(self.norm_init(self.Conv_0(to_nchw(x))))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        x = F.hardswish(self.norm_head(self.Conv_1(x)))
        x = F.hardswish(self.Dense_0(x.mean(dim=(2, 3))))
        return self.classifier(x)

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)
