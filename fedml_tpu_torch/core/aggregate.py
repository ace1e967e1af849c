"""Aggregation primitives of the port, the list form (counterpart of
``fedml_tpu/core/aggregate.py``).

Client updates are ``(sample_num, {name: tensor})`` pairs, aggregated on the
host side of the round (the ``sp`` simulator; the cross-silo server later):
``weighted_mean`` (FedAvg) or ``unweighted_sum`` (the ``_seq`` modes), in
fp32; ``tree_stack`` / ``tree_unstack`` put a list of trees on a leading axis
and back.  The stacked form lives in the round simulator
(``simulation/xla/fed_sim.py``); the compiled plane (``agg_plane:
compiled``) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

Tree = Dict[str, torch.Tensor]
Updates = Sequence[Tuple[float, Tree]]
COMPILED_PLANE_REFUSAL = ("agg_plane='compiled' is not ported yet "
                          "(ROADMAP.md queue A, item 10: server planes)")


def tree_sum(trees: Sequence[Tree]) -> Tree:
    out = dict(trees[0])
    for t in trees[1:]:
        out = {k: out[k] + t[k] for k in out}
    return out


def tree_scale(tree: Tree, scalar) -> Tree:
    return {k: v * scalar for k, v in tree.items()}


def tree_add(a: Tree, b: Tree) -> Tree:
    return {k: a[k] + b[k] for k in a}


def tree_sub(a: Tree, b: Tree) -> Tree:
    return {k: a[k] - b[k] for k in a}


def tree_zeros_like(tree: Tree) -> Tree:
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def tree_stack(trees: Sequence[Tree]) -> Tree:
    """Stack identically-shaped trees on a new leading axis (the gossip of
    ``simulation/sp/decentralized``); a missing leaf or a shape mismatch
    raises, naming the tree and the leaf."""
    names = list(trees[0])
    for i, t in enumerate(trees):
        if list(t) != names:
            raise ValueError(f"tree {i} has leaves {sorted(t)}, tree 0 has {sorted(names)}")
        for k in names:
            if t[k].shape != trees[0][k].shape:
                raise ValueError(f"tree {i} leaf {k!r}: shape {tuple(t[k].shape)}, "
                                 f"tree 0 has {tuple(trees[0][k].shape)}")
    return {k: torch.stack([t[k] for t in trees]) for k in names}


def tree_unstack(tree: Tree, n: int) -> List[Tree]:
    return [{k: v[i] for k, v in tree.items()} for i in range(n)]


def weighted_mean(updates: Updates) -> Tree:
    """Sample-weighted average: sum_i (n_i / N) * params_i, in fp32, over
    every entry (BatchNorm's running averages too, as in the JAX package)."""
    total = float(sum(n for n, _ in updates))
    if total <= 0:
        raise ValueError("total sample count must be positive")
    return tree_sum([tree_scale({k: v.float() for k, v in p.items()}, n / total)
                     for n, p in updates])


def unweighted_sum(updates: Updates) -> Tree:
    """The ``FedAvg_seq`` / ``FedOpt_seq`` mode: the plain sum."""
    return tree_sum([p for _, p in updates])


class FedMLAggOperator:
    _SUM_MODE = {"FedAvg_seq", "FedOpt_seq"}

    @staticmethod
    def agg(args, raw_grad_list: Updates) -> Tree:
        if str(getattr(args, "agg_plane", "host") or "host") == "compiled":
            raise NotImplementedError(COMPILED_PLANE_REFUSAL)
        if FedMLAggOperator.agg_mode(args) == "sum":
            return unweighted_sum(raw_grad_list)
        return weighted_mean(raw_grad_list)

    @staticmethod
    def agg_mode(args) -> str:
        opt = getattr(args, "federated_optimizer", "FedAvg")
        return "sum" if opt in FedMLAggOperator._SUM_MODE else "mean"
