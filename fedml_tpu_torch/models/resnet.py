"""CIFAR-style ResNets of the port: counterpart of ``fedml_tpu/models/resnet.py``.

``CifarResNet`` (ResNet-20/56: 3 stages of 16/32/64 filters) and
``ResNet18``, GroupNorm only.  Each module is built on the device its caller
names (the hub builds on ``meta``) and filled by ``init_parameters``, as the
``TransformerLM`` is.  What each layer does follows the flax modules:

* **Layout.** The model takes NHWC input, as the flax one does.  Its entry
  permutes it to NCHW; for a contiguous NHWC tensor that is already a
  ``channels_last`` NCHW tensor, so no copy is made.  The convolution weights
  are kept ``channels_last`` as well.
* **Padding.** flax ``padding="SAME"`` pads ``k - 1`` minus the stride's
  overhang, the smaller half before: a 3x3 stride-2 convolution over an even
  size pads (0, 1), where torch's ``padding=1`` would pad (1, 1).  The pads are
  computed from the input's size (``_same_pads``) and applied with ``F.pad``
  where they are not symmetric.
* **GroupNorm.** Groups of 16 channels (flax ``group_size=16``), epsilon
  1e-6 (flax's default; torch's is 1e-5).  The statistics and the
  normalisation run in fp32 on the fp32 input with fp32 scale and bias, and
  the result is cast to the compute dtype, as flax does under ``dtype=bf16``.
  flax 0.12 takes the variance as E[x²] - E[x]² (``use_fast_variance``),
  torch as the mean squared deviation: the same in exact arithmetic, and in
  fp32 where |mean| is not large against the spread.
* **Compute dtype.** Parameters stay fp32.  The input, each convolution
  weight and the classifier's weight and bias are cast to ``dtype`` where
  they are used, so in bf16 the convolutions, the residual adds, the spatial
  mean and the classifier run in bf16; the loss promotes the logits to fp32.
* **Init.** flax's: convolution and classifier kernels lecun-normal (a
  normal truncated at two standard deviations, std 1/sqrt(fan_in)), zero
  bias, GroupNorm scale 1 and bias 0.

BatchNorm (``norm="bn"``) is not ported: it needs buffers in the engine
(ROADMAP.md queue A, item 4: model zoo and trainers, with BatchNorm).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

GROUP_SIZE = 16
GN_EPSILON = 1e-6
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of flax/XLA ``SAME`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    """x (NCHW) padded for a ``SAME`` window of k x k at ``stride``, and the
    symmetric padding left for the op itself to apply."""
    (t, b), (l, r) = (_same_pads(x.shape[2], k, stride), _same_pads(x.shape[3], k, stride))
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


class SameConv(nn.Conv2d):
    """flax ``nn.Conv(features, (k, k), strides, padding="SAME",
    use_bias=bias, feature_group_count=groups)`` computing in ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, device=None, *, bias: bool = False,
                 groups: int = 1):
        super().__init__(cin, cout, k, stride=stride, bias=bias, groups=groups, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, padding = _pad_same(x, self.kernel_size[0], self.stride[0])
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return F.conv2d(x, self.weight.to(self.compute_dtype), bias, stride=self.stride,
                        padding=padding, groups=self.groups)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm``: fp32 statistics and normalisation, the result in
    ``dtype``.  ``num_groups`` defaults to groups of 16 channels (flax
    ``group_size=16``, the ResNets')."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32, device=None, *,
                 num_groups: int = 0):
        super().__init__(num_groups or channels // GROUP_SIZE, channels, eps=GN_EPSILON,
                         device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


def _check_norm(norm: str) -> None:
    if norm == "bn":
        raise NotImplementedError(
            "model_norm 'bn' (BatchNorm) is not ported yet: it needs buffers in the "
            "engine (ROADMAP.md queue A, item 4: model zoo and trainers, with BatchNorm)")
    if norm != "gn":
        raise ValueError(f"unknown norm {norm!r}")


class BasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv1 = SameConv(cin, filters, 3, stride, dtype, device)
        self.norm1 = GroupNorm(filters, dtype, device)
        self.conv2 = SameConv(filters, filters, 3, 1, dtype, device)
        self.norm2 = GroupNorm(filters, dtype, device)
        # flax projects when the residual's shape differs from the output's
        self.project = stride != 1 or cin != filters
        if self.project:
            self.proj = SameConv(cin, filters, 1, stride, dtype, device)
            self.norm_proj = GroupNorm(filters, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        residual = self.norm_proj(self.proj(x)) if self.project else x
        return F.relu(y + residual)


class _ResNet(nn.Module):
    """Stem, stages of ``BasicBlock``s named ``stage{s}_block{b}`` (the flax
    names), spatial mean and a dense classifier."""

    def __init__(self, stem: int, stem_k: int, stem_stride: int, stages: Sequence[int],
                 num_blocks: int, num_classes: int, norm: str, dtype: torch.dtype,
                 in_channels: int, max_pool: bool, device):
        super().__init__()
        _check_norm(norm)
        self.dtype = dtype
        self.max_pool = max_pool
        self.conv_init = SameConv(in_channels, stem, stem_k, stem_stride, dtype, device)
        self.norm_init = GroupNorm(stem, dtype, device)
        self.block_names: List[str] = []
        cin = stem
        for stage, filters in enumerate(stages):
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                name = f"stage{stage}_block{block}"
                self.add_module(name, BasicBlock(cin, filters, stride, dtype, device))
                self.block_names.append(name)
                cin = filters
        self.classifier = nn.Linear(cin, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        # NHWC -> NCHW: a view, channels_last when x is contiguous NHWC
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.norm_init(self.conv_init(x)))
        if self.max_pool:
            x, padding = _pad_same(x, 3, 2, value=-math.inf)
            x = F.max_pool2d(x, 3, 2, padding=padding)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return F.linear(x, self.classifier.weight.to(self.dtype),
                        self.classifier.bias.to(self.dtype))

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init in place: a normal truncated at two standard
    deviations, rescaled to std 1/sqrt(fan_in)."""
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def flax_init(root: nn.Module, generator: torch.Generator) -> None:
    """Fill ``root``'s parameters in place with flax's default initialisers, in
    ``root.modules()`` order: convolution and dense kernels lecun-normal
    (fan-in: a convolution's weight per output channel, a transposed
    convolution's kh*kw*in, a dense layer's input width), embeddings
    N(0, 1/dim), every bias zero, norm scales one; a dense layer marked
    ``orthogonal`` (an LSTM cell's recurrent kernels) takes an orthogonal
    kernel.  Convolution weights end ``channels_last``."""
    with torch.no_grad():
        for module in root.modules():
            if getattr(module, "orthogonal", False):
                nn.init.orthogonal_(module.weight, generator=generator)
            elif isinstance(module, (nn.Conv2d, nn.Linear)):
                lecun_normal_(module.weight, module.weight[0].numel(), generator)
            elif isinstance(module, nn.ConvTranspose2d):
                w = module.weight  # [in, out, kh, kw]
                lecun_normal_(w, w.shape[0] * w.shape[2] * w.shape[3], generator)
            elif isinstance(module, nn.Embedding):
                module.weight.normal_(0.0, 1.0 / math.sqrt(module.weight.shape[1]),
                                      generator=generator)
            elif isinstance(module, nn.GroupNorm):
                module.weight.fill_(1.0)
            else:
                continue
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
                module.weight.data = module.weight.data.contiguous(
                    memory_format=torch.channels_last)


class CifarResNet(_ResNet):
    """3-stage CIFAR ResNet: depth = 6n+2 (n blocks a stage, 16/32/64 filters)."""

    def __init__(self, num_blocks: int, num_classes: int = 10, norm: str = "gn",
                 dtype: torch.dtype = torch.float32, in_channels: int = 3, device=None):
        super().__init__(16, 3, 1, (16, 32, 64), num_blocks, num_classes, norm, dtype,
                         in_channels, False, device)


class ResNet18(_ResNet):
    """ImageNet-style ResNet-18 with GroupNorm (the fed_cifar100 model):
    ``small_images`` takes a 3x3 stem and no max-pool, else a 7x7 stride-2
    stem and a 3x3 stride-2 max-pool."""

    def __init__(self, num_classes: int = 100, norm: str = "gn", small_images: bool = True,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3, device=None):
        k, s = (3, 1) if small_images else (7, 2)
        super().__init__(64, k, s, (64, 128, 256, 512), 2, num_classes, norm, dtype,
                         in_channels, not small_images, device)


def resnet20(num_classes: int = 10, norm: str = "gn", dtype=torch.float32,
             device=None) -> CifarResNet:
    return CifarResNet(3, num_classes, norm, dtype, device=device)


def resnet56(num_classes: int = 10, norm: str = "gn", dtype=torch.float32,
             device=None) -> CifarResNet:
    return CifarResNet(9, num_classes, norm, dtype, device=device)


def resnet18_gn(num_classes: int = 100, dtype=torch.float32, device=None) -> ResNet18:
    return ResNet18(num_classes, "gn", dtype=dtype, device=device)
