"""Model factory keyed on (model, dataset), counterpart of
``fedml_tpu/models/hub.py``.

``create`` returns the module built on the ``meta`` device: a description with
shapes and no storage, as the flax hub returns an uninitialised module.  The
engine materialises it on the run's device and fills it from a seeded
generator (``ml.engine.train.init_variables``).  Only the ``transformer`` key
is ported; the other keys raise ``NotImplementedError`` naming the ROADMAP.md
item that ports them.
"""

from __future__ import annotations

import logging
from typing import Any

import torch
from torch import nn

logger = logging.getLogger(__name__)

# the models the JAX hub plumbs compute_dtype into; the transformer is not one
_RESNETS = {"resnet20", "resnet56", "resnet18", "resnet18_gn"}


def create(args: Any, output_dim: int) -> nn.Module:
    name = str(getattr(args, "model", "lr")).lower()
    dataset = str(getattr(args, "dataset", "")).lower()

    if _dtype(args) is not torch.float32 and name not in _RESNETS:
        logger.warning(
            "compute_dtype=%s is only plumbed into %s; model %r runs fp32",
            getattr(args, "compute_dtype", None), sorted(_RESNETS), name,
        )
    if name in ("transformer", "fedtransformer"):
        from .transformer import TransformerConfig, TransformerLM

        return TransformerLM(TransformerConfig(vocab_size=max(output_dim, 256)), device="meta")
    if name in _RESNETS:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md queue A, item 3: ResNet model)")
    raise NotImplementedError(
        f"model {name!r} for dataset {dataset!r} is not ported yet "
        "(ROADMAP.md queue A, item 14: model zoo and trainers)")


def _parse_dtype(name: str, arg_name: str) -> torch.dtype:
    if name in ("fp32", "float32"):
        return torch.float32
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"unknown {arg_name} {name!r} (use fp32 or bf16)")


def _dtype(args: Any) -> torch.dtype:
    """Compute dtype from ``args.compute_dtype`` ('fp32' or 'bf16')."""
    return _parse_dtype(
        str(getattr(args, "compute_dtype", "fp32") or "fp32").lower(), "compute_dtype"
    )
