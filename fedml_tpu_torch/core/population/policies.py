"""Cohort selection of the port (counterpart of
``fedml_tpu/core/population/policies.py``): the uniform policy with the
simulator's ``mt19937`` schedule, ``RandomState(round_idx)`` drawing without
replacement, so cohorts match the JAX package's bit for bit.  The stratified
and importance policies are a later slice (ROADMAP.md queue A, item 6a: the stratified
and importance policies)."""

from __future__ import annotations

import numpy as np

from .registry import ClientRegistry


class UniformPolicy:
    name = "uniform"

    def __init__(self, registry: ClientRegistry, rng_style: str = "mt19937"):
        if rng_style != "mt19937":
            raise NotImplementedError(
                f"rng_style {rng_style!r} (the cross-silo schedule) is not ported yet "
                "(ROADMAP.md queue A, item 9a: transport and cross-silo FedAvg)")
        self.registry = registry

    def select(self, round_idx: int, k: int) -> np.ndarray:
        eligible = self.registry.eligible_ids()
        if k >= eligible.size:
            return eligible.copy()
        rs = np.random.RandomState(round_idx)
        return eligible[rs.choice(eligible.size, k, replace=False)]


def make_policy(name: str, registry: ClientRegistry, *, rng_style: str = "mt19937"):
    name = str(name or "uniform").lower()
    if name == "uniform":
        return UniformPolicy(registry, rng_style=rng_style)
    if name in ("stratified", "importance"):
        raise NotImplementedError(
            f"selection_policy {name!r} is not ported yet (ROADMAP.md queue A, item 6a: "
            "the stratified and importance policies)")
    raise ValueError(
        f"unknown selection_policy {name!r} (expected uniform|stratified|importance)")
