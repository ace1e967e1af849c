"""Sequence-parallel TransformerLM of the port.

Counterpart of ``fedml_tpu/parallel/seq_parallel.py``: the same model and
weights run with the tokens cut into n = ``mesh.shape["sp"]`` shards of L/n.
On one card the shards lie along the batch: the position-wise layers run on
[n * B, L/n] tokens with their global positions (RoPE takes absolute
indices, so no shard needs a fix-up), and every layer's attention is exact
ring attention over the shards (:mod:`.ring_attention`), each K/V shard
folded into the running online-softmax state by K4.  The whole sequence lives
in the one card's memory.

Parameters are a variables dict (name -> tensor), as in the engine.  They are
applied to a module built on the ``meta`` device with
``torch.func.functional_call``, so a call copies no weights and gradients
reach the dict's tensors.  The loss is the mean next-token cross-entropy over
all tokens, taken in the logits' dtype (bf16 in bf16 compute) as the JAX
package's ``optax.softmax_cross_entropy_with_integer_labels`` and ``jnp.sum``
take it; only the division by the token count is fp32.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch.func import functional_call

from ..device import get_device
from ..ml.engine.train import Variables, init_variables
from ..models.transformer import TransformerConfig, TransformerLM
from .mesh import Mesh
from .ring_attention import ring_attention_inner


def make_sp_model(cfg: TransformerConfig, mesh: Mesh, axis_name: str = "sp") -> TransformerLM:
    """A TransformerLM on the ``meta`` device whose attention is ring attention
    over the mesh's ``axis_name``; apply it with :func:`sp_apply` or
    :func:`sp_loss_fn`, which lay the tokens out as it expects."""
    attention = partial(ring_attention_inner, n=mesh.shape[axis_name], causal=True)
    return TransformerLM(cfg, attention_fn=attention, device="meta")


def _shard(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, L, ...] -> [n * B, L / n, ...], shard-major."""
    B, L = x.shape[:2]
    if L % n:
        raise ValueError(f"seq len {L} not divisible by sp={n}")
    return x.unflatten(1, (n, L // n)).transpose(0, 1).flatten(0, 1)


def _sharded_logits(model: TransformerLM, params: Variables, tokens: torch.Tensor,
                    mesh: Mesh, axis_name: str) -> torch.Tensor:
    """Logits [n * B, L / n, vocab] of the shard-major token layout."""
    if tokens.device != mesh.device:
        raise ValueError(f"tokens on {tokens.device}, mesh on {mesh.device}")
    n = mesh.shape[axis_name]
    B, L = tokens.shape
    positions = torch.arange(L, device=tokens.device).view(1, L).expand(B, L)
    return functional_call(model, params, (_shard(tokens, n),),
                           {"positions": _shard(positions, n)})


def sp_apply(cfg: TransformerConfig, params: Variables, tokens: torch.Tensor, mesh: Mesh,
             axis_name: str = "sp") -> torch.Tensor:
    """Sequence-parallel forward: tokens [B, L] (L divisible by the axis size)
    -> logits [B, L, vocab], the single-card forward's up to summation order."""
    n = mesh.shape[axis_name]
    logits = _sharded_logits(make_sp_model(cfg, mesh, axis_name), params, tokens, mesh,
                             axis_name)
    B, L = tokens.shape
    return logits.unflatten(0, (n, B)).transpose(0, 1).reshape(B, L, -1)


def sp_init(cfg: TransformerConfig, seed: int = 0,
            device: Optional[torch.device] = None) -> Variables:
    """Parameters of the sp model (shapes do not depend on L): the flax
    initialisers' distributions drawn from a CPU generator seeded with
    ``seed``, on ``device`` (the card unless another is given)."""
    model = TransformerLM(cfg, device="meta")
    return init_variables(model, device if device is not None else get_device(), seed)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy in the logits' dtype, as
    ``optax.softmax_cross_entropy_with_integer_labels`` computes it: the log
    of the summed exponentials of the max-shifted logits, plus the max, minus
    the label's logit."""
    amax = logits.detach().amax(dim=-1, keepdim=True)
    amax = torch.where(amax.isfinite(), amax, torch.zeros_like(amax))
    lse = torch.log(torch.exp(logits - amax).sum(dim=-1)) + amax.squeeze(-1)
    return lse - logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)


def sp_loss_fn(cfg: TransformerConfig, mesh: Mesh, axis_name: str = "sp"):
    """``loss(params, tokens, targets) -> scalar``: the mean next-token
    cross-entropy over all B * L tokens of the sequence-parallel forward,
    differentiable in ``params``.  Each shard's sum is taken in the logits'
    dtype, then the shards' sums (the JAX package's ``psum``); the mean is
    that total over the fp32 token count, as in the JAX package."""
    model = make_sp_model(cfg, mesh, axis_name)
    n = mesh.shape[axis_name]

    def loss(params: Variables, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        logits = _sharded_logits(model, params, tokens, mesh, axis_name)
        per = softmax_cross_entropy(logits, _shard(targets, n))  # [n * B, L / n]
        total = per.unflatten(0, (n, -1)).flatten(1).sum(dim=1).sum()
        return total.float() / float(per.numel())

    return loss
