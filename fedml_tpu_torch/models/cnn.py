"""The CNN zoo slice of the port: counterpart of ``fedml_tpu/models/cnn.py``.

* ``CNN_DropOut``: the FedAvg paper's 2-conv + 2-dense CNN of (Fed)EMNIST,
  ``only_digits`` switching 10 against 62 classes;
* ``CNN_WEB``: a compact MNIST CNN.

Both take NHWC input ([B, H, W] gains a channel axis), compute in NCHW
(the permute of a contiguous NHWC tensor is a ``channels_last`` view) and
flatten in the flax order: the feature map goes back to NHWC before the
reshape, so the first dense layer reads (H, W, C) rows, the flax kernel's.
flax infers the dense layer's input width at init; here the caller names the
input's spatial size (the hub takes it from the dataset's shape).

``Dropout`` is flax ``nn.Dropout``: in training each element is kept with
probability 1 - rate and scaled by 1 / (1 - rate).  Its masks come from the
``torch.Generator`` in ``generator``, which the engine seeds for each
client run (``ml.engine.train.seed_dropout``); the JAX engine draws its
masks from ``jax.random``, which torch cannot reproduce (ROADMAP.md C,
"Random draws").  In eval mode it is the identity.  Under the chunked
round's ``torch.func.vmap``, which refuses a generator draw, the engine
draws each client's uniforms from that client's generator outside the
vmapped call and hands them in through ``chunk_u``
(``ml.engine.train.build_chunked_local_train``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import SameConv, flax_init


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None  # None: torch's global stream
        self.chunk_u: Optional[torch.Tensor] = None  # a chunked step's uniforms

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = self.chunk_u
        if u is None:
            u = torch.rand(x.shape, generator=self.generator, device=x.device,
                           dtype=torch.float32)
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W] or [B, H, W, C] NHWC input -> fp32 NCHW (a view)."""
    if x.dim() == 3:
        x = x[..., None]
    return x.float().permute(0, 3, 1, 2)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W*C] in flax's (H, W, C) row order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class CNN_DropOut(nn.Module):
    def __init__(self, only_digits: bool = True, num_classes: int = 0, in_hw=(28, 28),
                 in_channels: int = 1, device=None):
        super().__init__()
        self.conv2d_1 = nn.Conv2d(in_channels, 32, 3, device=device)  # VALID
        self.conv2d_2 = nn.Conv2d(32, 64, 3, device=device)
        self.drop1 = Dropout(0.25)
        h, w = (in_hw[0] - 4) // 2, (in_hw[1] - 4) // 2
        self.dense_1 = nn.Linear(h * w * 64, 128, device=device)
        self.drop2 = Dropout(0.5)
        head = num_classes or (10 if only_digits else 62)
        self.dense_2 = nn.Linear(128, head, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv2d_1(to_nchw(x)))
        x = F.relu(self.conv2d_2(x))
        x = self.drop1(F.max_pool2d(x, 2, 2))
        x = self.drop2(F.relu(self.dense_1(flatten_nhwc(x))))
        return self.dense_2(x)

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)


class CNN_WEB(nn.Module):
    """Two SAME 5x5 convolutions with 2x2 max-pools, then two dense layers;
    the flax auto-names (``Conv_0``, ``Dense_0``, ...) are the module names."""

    def __init__(self, output_dim: int = 10, in_hw=(28, 28), in_channels: int = 1, device=None):
        super().__init__()
        self.Conv_0 = SameConv(in_channels, 32, 5, device=device, bias=True)
        self.Conv_1 = SameConv(32, 64, 5, device=device, bias=True)
        h, w = in_hw[0] // 2 // 2, in_hw[1] // 2 // 2
        self.Dense_0 = nn.Linear(h * w * 64, 512, device=device)
        self.Dense_1 = nn.Linear(512, output_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.Conv_0(to_nchw(x))), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = F.relu(self.Dense_0(flatten_nhwc(x)))
        return self.Dense_1(x)

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)
