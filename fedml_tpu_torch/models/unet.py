"""U-Net of the port for federated semantic segmentation (FedSeg):
counterpart of ``fedml_tpu/models/unet.py`` (``UNet``, ``iou_counts``,
``mean_iou``).

An encoder-decoder with skip connections: ``_ConvBlock``s of two SAME 3x3
convolutions with bias, each followed by GroupNorm of ``min(8, c)`` groups
(epsilon 1e-6) and a relu; 2x2 max-pools down, 2x2 stride-2 transposed
convolutions up, the skip concatenated after the upsampled map, and a 1x1
convolution to the class logits.  Input [B, H, W, C] (H, W divisible by 4),
logits [B, H, W, num_classes]; NCHW inside.

flax's ``ConvTranspose`` (``transpose_kernel=False``, SAME) correlates the
stride-dilated input with its kernel as it is, where torch's
``conv_transpose2d`` (the gradient of a convolution) runs the kernel flipped
in both spatial axes.  ``ConvTranspose`` keeps its weight in flax's
orientation ([in, out, kh, kw], the flax [kh, kw, in, out] kernel permuted)
and flips it where it is used, so the weight and the flax leaf hold the same
numbers.  At kernel == stride (the U-Net's 2x2 / 2) SAME needs no padding:
output pixel (s*m + r) is input pixel m times kernel tap k-1-r.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .cnn import to_nchw
from .resnet import GroupNorm, SameConv, flax_init


def _gn(c: int, device) -> GroupNorm:
    return GroupNorm(c, device=device, num_groups=min(8, c))


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(features, (k, k), strides=(s, s),
    padding="SAME")`` with bias; ``stride`` defaults to ``k``.

    lax pads the stride-dilated input by (a, b) with a = k - 1 when s > k - 1,
    else ceil((k + s - 2) / 2), and b = k + s - 2 - a; torch's ``padding=p``
    pads it by k - 1 - p on each side, so p = k - 1 - a (0 at k = s = 2, 1 at
    the GAN's k 4, s 2).  Only the symmetric cases are built."""

    def __init__(self, cin: int, cout: int, k: int, device=None, *, stride: int = 0):
        s = stride or k
        pad_a = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
        if 2 * pad_a != k + s - 2:
            raise ValueError(f"SAME transposed convolution k {k}, stride {s} pads unevenly")
        super().__init__(cin, cout, k, stride=s, padding=k - 1 - pad_a, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.flip(2, 3), self.bias, stride=self.stride,
                                  padding=self.padding)


class _ConvBlock(nn.Module):
    def __init__(self, cin: int, width: int, device=None):
        super().__init__()
        self.Conv_0 = SameConv(cin, width, 3, device=device, bias=True)
        self.GroupNorm_0 = _gn(width, device)
        self.Conv_1 = SameConv(width, width, 3, device=device, bias=True)
        self.GroupNorm_1 = _gn(width, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        return F.relu(self.GroupNorm_1(self.Conv_1(x)))


class UNet(nn.Module):
    def __init__(self, num_classes: int, width: int = 16, in_channels: int = 3, device=None):
        super().__init__()
        w = width
        self._ConvBlock_0 = _ConvBlock(in_channels, w, device)
        self._ConvBlock_1 = _ConvBlock(w, 2 * w, device)
        self._ConvBlock_2 = _ConvBlock(2 * w, 4 * w, device)
        self.ConvTranspose_0 = ConvTranspose(4 * w, 2 * w, 2, device)
        self._ConvBlock_3 = _ConvBlock(4 * w, 2 * w, device)
        self.ConvTranspose_1 = ConvTranspose(2 * w, w, 2, device)
        self._ConvBlock_4 = _ConvBlock(2 * w, w, device)
        self.Conv_0 = SameConv(w, num_classes, 1, device=device, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e1 = self._ConvBlock_0(to_nchw(x))                         # H
        e2 = self._ConvBlock_1(F.max_pool2d(e1, 2, 2))             # H/2
        b = self._ConvBlock_2(F.max_pool2d(e2, 2, 2))              # H/4
        d2 = self._ConvBlock_3(torch.cat([self.ConvTranspose_0(b), e2], dim=1))
        d1 = self._ConvBlock_4(torch.cat([self.ConvTranspose_1(d2), e1], dim=1))
        return self.Conv_0(d1).permute(0, 2, 3, 1)  # NHWC logits

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)


def iou_counts(logits: torch.Tensor, masks: torch.Tensor, num_classes: int):
    """Per-class (intersection, union) pixel counts ([num_classes] int64):
    accumulate them over batches and divide once for a dataset-level mIoU
    (a batch mean is biased when classes are sparse)."""
    pred = logits.argmax(dim=-1)
    classes = torch.arange(num_classes, device=pred.device)
    p = pred.reshape(1, -1) == classes[:, None]
    t = masks.reshape(1, -1).to(pred.device) == classes[:, None]
    return (p & t).sum(dim=1), (p | t).sum(dim=1)


def mean_iou(logits: torch.Tensor, masks: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Mean intersection over union over the classes present in the target
    or the prediction (NaN when none is)."""
    inter, union = iou_counts(logits, masks, num_classes)
    ious = torch.where(union > 0, inter / union.clamp_min(1), torch.nan)
    return torch.nanmean(ious.float())
