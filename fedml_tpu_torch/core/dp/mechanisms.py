"""DP noise mechanisms over dicts of tensors (counterpart of
``fedml_tpu/core/dp/mechanisms.py``).

The classic Gaussian mechanism, sigma = sqrt(2 ln(1.25/delta)) *
sensitivity / epsilon, and the Laplace mechanism, scale = sensitivity /
epsilon.  Drawing and adding are separate: ``noise_like(tree, gen)`` draws
each floating leaf's noise in fp32 from ``gen`` on the leaf's device, and
``apply(tree, noise)`` adds it, cast to the leaf's dtype, as the JAX package
does.  A test can so feed ``jax.random``'s draw through the port's
arithmetic.  Non-float leaves pass through unchanged.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]

# jax.random.laplace's uniform draw: [-1 + epsneg(fp32), 1)
_LAPLACE_LOW = -1.0 + 2.0 ** -24


def laplace_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """A standard Laplace sample from ``u`` uniform on [-1 + 2^-24, 1), the
    inverse CDF of ``jax.random.laplace``: sign(u) * log1p(-|u|)."""
    return torch.sign(u) * torch.log1p(-u.abs())


def laplace_uniform(shape, gen: torch.Generator, device) -> torch.Tensor:
    """The uniform draw ``laplace_from_uniform`` takes."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return (u * (1.0 - _LAPLACE_LOW) + _LAPLACE_LOW).clamp_min_(_LAPLACE_LOW)


def apply(tree: Tree, noise: Tree) -> Tree:
    """``tree + noise`` leaf by leaf, each sum cast to its leaf's dtype;
    leaves without noise (non-float) are returned as they are."""
    return {k: (v + noise[k].to(v.dtype)) if k in noise else v for k, v in tree.items()}


class _Mechanism:
    def _standard(self, shape, gen: torch.Generator, device) -> torch.Tensor:
        raise NotImplementedError

    def noise_like(self, tree: Tree, gen: torch.Generator) -> Tree:
        """The noise of every floating leaf of ``tree``, fp32, on its device."""
        return {k: self.scale_noise(self._standard(v.shape, gen, v.device))
                for k, v in tree.items() if v.is_floating_point()}

    def add_noise(self, tree: Tree, gen: torch.Generator) -> Tree:
        return apply(tree, self.noise_like(tree, gen))


class Gaussian(_Mechanism):
    def __init__(self, epsilon: float, delta: float, sensitivity: float = 1.0):
        if not 0 < float(delta) < 1:
            raise ValueError("delta must be in (0, 1)")
        if float(epsilon) <= 0:
            raise ValueError("epsilon must be positive")
        self.epsilon = float(epsilon)
        self.delta = float(delta)
        self.sensitivity = float(sensitivity)
        self.sigma = self.compute_sigma(self.epsilon, self.delta, self.sensitivity)

    @staticmethod
    def compute_sigma(epsilon: float, delta: float, sensitivity: float) -> float:
        return math.sqrt(2.0 * math.log(1.25 / delta)) * sensitivity / epsilon

    def _standard(self, shape, gen, device):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    def scale_noise(self, standard: torch.Tensor) -> torch.Tensor:
        return self.sigma * standard


class Laplace(_Mechanism):
    def __init__(self, epsilon: float, sensitivity: float = 1.0):
        if float(epsilon) <= 0:
            raise ValueError("epsilon must be positive")
        self.epsilon = float(epsilon)
        self.sensitivity = float(sensitivity)
        self.scale = self.sensitivity / self.epsilon

    def _standard(self, shape, gen, device):
        return laplace_from_uniform(laplace_uniform(shape, gen, device))

    def scale_noise(self, standard: torch.Tensor) -> torch.Tensor:
        return self.scale * standard


def create_mechanism(mechanism_type: str, epsilon: float, delta: float,
                     sensitivity: float) -> _Mechanism:
    mechanism_type = mechanism_type.lower()
    if mechanism_type == "gaussian":
        return Gaussian(epsilon, delta, sensitivity)
    if mechanism_type == "laplace":
        return Laplace(epsilon, sensitivity)
    raise ValueError(f"unknown DP mechanism: {mechanism_type!r}")
