"""The MNIST GAN pair of the port (FedGAN): counterpart of
``fedml_tpu/models/gan.py`` (``MNISTGenerator``, ``MNISTDiscriminator``).

* ``MNISTGenerator``: a dense layer to 7*7*128 and a relu, a reshape in NHWC
  order, then two 4x4 stride-2 SAME transposed convolutions (128 -> 64, relu,
  64 -> 1) and a tanh: [B, latent] -> [B, 28, 28, 1] images in (-1, 1).  The
  transposed convolutions keep flax's unflipped kernel orientation and its
  (2, 2) padding of the dilated input (``models/unet.py``'s
  ``ConvTranspose``, torch ``padding=1``).
* ``MNISTDiscriminator``: two 4x4 stride-2 SAME convolutions (64, 128; the
  pads are (1, 1) at 28 and at 14) each followed by a leaky relu of slope
  0.2, an NHWC flatten and one dense logit.  A [B, 28, 28] input gains a
  channel axis.

The modules carry flax's names (``fc``, ``deconv1``, ``deconv2``; ``conv1``,
``conv2``, ``head``), so ``models/convert.py`` maps their leaves by its one
rule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .cnn import flatten_nhwc, to_nchw
from .resnet import SameConv, flax_init
from .unet import ConvTranspose


class MNISTGenerator(nn.Module):
    def __init__(self, latent_dim: int = 100, device=None):
        super().__init__()
        self.latent_dim = int(latent_dim)
        self.fc = nn.Linear(self.latent_dim, 7 * 7 * 128, device=device)
        self.deconv1 = ConvTranspose(128, 64, 4, device, stride=2)
        self.deconv2 = ConvTranspose(64, 1, 4, device, stride=2)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fc(z)).reshape(z.shape[0], 7, 7, 128).permute(0, 3, 1, 2)
        x = self.deconv2(F.relu(self.deconv1(x)))
        return torch.tanh(x).permute(0, 2, 3, 1)  # NHWC

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)


class MNISTDiscriminator(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.conv1 = SameConv(1, 64, 4, 2, device=device, bias=True)
        self.conv2 = SameConv(64, 128, 4, 2, device=device, bias=True)
        self.head = nn.Linear(7 * 7 * 128, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv1(to_nchw(x)), 0.2)
        x = F.leaky_relu(self.conv2(x), 0.2)
        return self.head(flatten_nhwc(x))

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)
