"""The DARTS search space of the port (FedNAS): counterpart of
``fedml_tpu/models/darts.py``.

One searched cell: each of ``STEPS`` intermediate nodes sums a ``MixedOp``
over each of the ``PREV`` states before it, and a ``MixedOp`` is the
softmax(alpha)-weighted sum of the candidate ops ``OPS`` on its edge.  The
architecture logits (``alphas``, [num_edges, len(OPS)]) are a tensor of their
own, passed at call time and trained beside the weights.

What each layer does follows the flax modules:

* the stem: a SAME 3x3 convolution with bias, GroupNorm of ``min(8, c)``
  groups (epsilon 1e-6) and a relu (s0), then a 3x3 stride-2 SAME one (s1:
  its pads are (0, 1) at 32, ``resnet._same_pads``), and s0 average-pooled
  2x2 / 2 to s1's size;
* the ops: ``skip``; ``conv3`` and ``conv1`` (a convolution with bias,
  GroupNorm, relu); ``avgpool``, a 3x3 stride-1 SAME average that divides by
  the full window at the borders (flax's ``count_include_pad``); ``zero``,
  whose output and gradient are zero, so its term is left out of the sum
  (its alpha still takes its softmax gradient);
* the head: the mean over H and W of the last node, then a dense layer.

The modules carry flax's auto-names (``Conv_0``, ``GroupNorm_1``,
``MixedOp_3`` with ``Conv_0``, ``GroupNorm_0``, ``Conv_1``, ``GroupNorm_1``
inside, ``Dense_0``), so ``models/convert.py`` maps their leaves by its one
rule.  ``init_alphas`` draws 1e-3 N(0, 1) from a CPU ``torch.Generator``
(``utils/rng.py``), where the JAX package draws from ``PRNGKey(seed)``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.rng import ALPHAS_SALT, seeded_generator
from .cnn import to_nchw
from .resnet import GroupNorm, SameConv, flax_init

OPS = ("skip", "conv3", "conv1", "avgpool", "zero")
STEPS = 2  # intermediate nodes per cell
PREV = 2  # each node sees the 2 previous states


def num_edges() -> int:
    return STEPS * PREV


def _gn(c: int, device) -> GroupNorm:
    return GroupNorm(c, device=device, num_groups=min(8, c))


class MixedOp(nn.Module):
    """Softmax(alpha)-weighted sum of the candidate ops on one edge."""

    def __init__(self, width: int, device=None):
        super().__init__()
        self.Conv_0 = SameConv(width, width, 3, device=device, bias=True)
        self.GroupNorm_0 = _gn(width, device)
        self.Conv_1 = SameConv(width, width, 1, device=device, bias=True)
        self.GroupNorm_1 = _gn(width, device)

    def forward(self, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        outs = (
            x,  # skip
            F.relu(self.GroupNorm_0(self.Conv_0(x))),
            F.relu(self.GroupNorm_1(self.Conv_1(x))),
            F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True),
        )  # zero: no term
        acc = weights[0] * outs[0]
        for w, o in zip(weights[1:], outs[1:]):
            acc = acc + w * o
        return acc


class DARTSNetwork(nn.Module):
    """Stem -> one searched cell -> spatial mean -> classifier; NHWC input,
    ``alphas`` [num_edges, len(OPS)] logits at call time."""

    def __init__(self, num_classes: int = 10, width: int = 16, in_channels: int = 3,
                 device=None):
        super().__init__()
        self.Conv_0 = SameConv(in_channels, width, 3, device=device, bias=True)
        self.GroupNorm_0 = _gn(width, device)
        self.Conv_1 = SameConv(width, width, 3, 2, device=device, bias=True)
        self.GroupNorm_1 = _gn(width, device)
        for e in range(num_edges()):
            self.add_module(f"MixedOp_{e}", MixedOp(width, device))
        self.Dense_0 = nn.Linear(width, num_classes, device=device)

    def forward(self, x: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
        weights = torch.softmax(alphas, dim=-1)
        s0 = F.relu(self.GroupNorm_0(self.Conv_0(to_nchw(x))))
        s1 = F.relu(self.GroupNorm_1(self.Conv_1(s0)))
        states = [F.avg_pool2d(s0, 2, 2), s1]  # s0 to s1's size
        edge = 0
        for _ in range(STEPS):
            acc = None
            for j in range(PREV):
                out = getattr(self, f"MixedOp_{edge}")(states[-1 - j], weights[edge])
                acc = out if acc is None else acc + out
                edge += 1
            states.append(acc)
        return self.Dense_0(states[-1].mean(dim=(2, 3)))

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)


def init_alphas(seed: int = 0, device="cpu") -> torch.Tensor:
    """Near-uniform architecture logits, 1e-3 N(0, 1) [num_edges, len(OPS)],
    from the CPU generator of (seed, ``ALPHAS_SALT``)."""
    gen = seeded_generator((seed, ALPHAS_SALT))
    return (1e-3 * torch.randn((num_edges(), len(OPS)), generator=gen)).to(device)


def derive_architecture(alphas) -> List[Dict[str, Any]]:
    """Discrete genotype: the argmax op of each edge with ``zero`` masked to
    -inf, the first maximum on a tie (``jnp.argmax``'s rule)."""
    if isinstance(alphas, torch.Tensor):
        alphas = alphas.detach().cpu().numpy()
    masked = np.array(alphas, dtype=np.float64, copy=True)
    masked[:, OPS.index("zero")] = -np.inf
    choices = np.argmax(masked, axis=-1)
    genotype = []
    edge = 0
    for node in range(STEPS):
        for j in range(PREV):
            genotype.append({"node": node, "input": -1 - j, "op": OPS[int(choices[edge])]})
            edge += 1
    return genotype
