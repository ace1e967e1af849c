"""Ring attention of the port: exact attention over a sequence cut in shards.

Counterpart of ``fedml_tpu/parallel/ring_attention.py``.  There each chip of
the ``sp`` ring holds one sequence shard of Q/K/V; the K/V shards travel round
the ring by ``ppermute``, and each chip folds every shard that reaches it into
a running online-softmax state (max, denominator, unnormalised output), so the
full score matrix never exists and memory per chip is O(L/sp).

On one card the n shards lie along a leading shard axis of one tensor, so the
whole sequence lives in that card's memory: the O(L/sp) memory per chip is a
property of the multi-card ring (ROADMAP.md queue A, item 12: the ring across cards), not of this
one.  What is kept is the computation, fold for fold: at ring step r, shard
``my`` folds the K/V shard that the ring would have brought it, the one that
started on shard ``src = (my - r) mod n``.  The ``ppermute`` by +1 a step
becomes that index, so no shard is copied.  A call makes n * n folds, each one
launch of K4 on the card (``ops/csrc/flash_update.cu``; in bf16
``ops/csrc/flash_update_sm90.cu``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.flash_attention import flash_shard_update, shard_update_reference
from .mesh import Mesh

#: (q, k, v, q_pos, k_pos, causal, m, l, o) -> (m, l, o)
BlockFn = Callable[..., tuple]


#: the fused-softmax shard fold, the JAX package's default block function
_block_attend = shard_update_reference


def flash_block_attend(q, k, v, q_pos, k_pos, causal, m, l, o):
    """Drop-in for :func:`_block_attend` that folds the shard through K4 on a
    CUDA tensor and through its plain twin on a CPU tensor: the counterpart of
    ``pallas_block_attend``, and the port's default."""
    return flash_shard_update(q, k, v, q_pos, k_pos, m, l, o, causal)


def _ring(q, k, v, causal: bool, block_fn: BlockFn) -> torch.Tensor:
    """q, k, v [n, B, Ls, H, D], shard-major -> [n, B, Ls, H, D] in q's dtype."""
    n, B, Ls, H, D = q.shape
    pos = torch.arange(n * Ls, dtype=torch.int32, device=q.device).view(n, Ls)
    m0 = torch.full((B, H, Ls), float("-inf"), dtype=torch.float32, device=q.device)
    l0 = torch.zeros((B, H, Ls), dtype=torch.float32, device=q.device)
    o0 = torch.zeros((B, Ls, H, D), dtype=torch.float32, device=q.device)
    state = [(m0, l0, o0)] * n
    for r in range(n):
        for my in range(n):
            src = (my - r) % n  # ring shift r: the block started on shard my - r
            state[my] = block_fn(q[my], k[src], v[src], pos[my], pos[src], causal, *state[my])
    out = [(o / l.clamp_min(1e-20).permute(0, 2, 1)[..., None]).to(q.dtype) for _, l, o in state]
    return torch.stack(out)


def ring_attention_inner(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n: int,
                         causal: bool = True, block_fn: Optional[BlockFn] = None) -> torch.Tensor:
    """Exact attention over the shards of an ``sp`` axis of size ``n``, laid
    along the batch: q, k, v are [n * B, Ls, H, D] with shard ``i`` in rows
    ``i * B .. (i + 1) * B`` and holding global positions ``i * Ls ..``.  This is
    the sequence-parallel model's ``attention_fn``.  ``block_fn`` defaults to
    :func:`flash_block_attend`."""
    if q.shape[0] % n:
        raise ValueError(f"batch {q.shape[0]} does not hold {n} shards")
    out = _ring(q.unflatten(0, (n, -1)), k.unflatten(0, (n, -1)), v.unflatten(0, (n, -1)),
                causal, block_fn or flash_block_attend)
    return out.flatten(0, 1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis_name: str = "sp", causal: bool = True,
                   block_fn: Optional[BlockFn] = None) -> torch.Tensor:
    """Standalone ring attention: q, k, v are whole [B, L, H, D] tensors on
    ``mesh.device``; the sequence is cut into ``mesh.shape[axis_name]``
    shards and the result put back together as [B, L, H, D]."""
    n = mesh.shape[axis_name]
    B, L = q.shape[:2]
    if L % n:
        raise ValueError(f"seq len {L} not divisible by {axis_name}={n}")
    if q.device != mesh.device:
        raise ValueError(f"tensors on {q.device}, mesh on {mesh.device}")
    shards = [t.unflatten(1, (n, L // n)).transpose(0, 1) for t in (q, k, v)]
    out = _ring(*shards, causal, block_fn or flash_block_attend)
    return out.transpose(0, 1).reshape(q.shape)
