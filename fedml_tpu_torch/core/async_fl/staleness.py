"""Staleness-weighting policies for buffered-async aggregation (counterpart
of ``fedml_tpu/core/async_fl/staleness.py``).

A buffered delta trained against global-model version ``v`` and flushed at
version ``v + s`` has *staleness* ``s`` (the number of flushes it missed).
Its aggregation weight is ``n_samples * weight(policy, s)`` where
``weight`` is one of three closed-form down-weighting schedules (FedBuff,
arXiv:2106.06639 §3.2 — the polynomial family is the paper's ``s(t) =
1/(1+t)^a``; ``hinge`` tolerates a grace window before decaying):

* ``constant``:    ``1.0`` — staleness ignored.
* ``polynomial``:  ``(1 + s) ** -alpha``.
* ``hinge``:       ``1.0`` for ``s <= b``, else ``1 / (1 + alpha*(s-b))``.

:func:`staleness_weight` is the scalar form and :func:`staleness_weights`
the array form.  Staleness is a host number in the port's simulator (the
virtual arrival queue's), so the array form is numpy float32, the dtype the
JAX package's traced form computes in.
"""

from __future__ import annotations

import numpy as np

ASYNC_STALENESS_POLICIES = ("constant", "polynomial", "hinge")


def _check_policy(policy: str) -> str:
    p = str(policy).lower()
    if p not in ASYNC_STALENESS_POLICIES:
        raise ValueError(
            f"async_staleness_policy must be one of {ASYNC_STALENESS_POLICIES}, "
            f"got {policy!r}")
    return p


def staleness_weight(policy: str, staleness: float, alpha: float = 0.5,
                     hinge_b: int = 4) -> float:
    """Scalar weight multiplier for one delta of the given staleness."""
    p = _check_policy(policy)
    s = float(staleness)
    if s < 0:
        raise ValueError(f"staleness must be >= 0, got {s}")
    if p == "constant":
        return 1.0
    if p == "polynomial":
        return float((1.0 + s) ** -float(alpha))
    b = float(hinge_b)
    if s <= b:
        return 1.0
    return float(1.0 / (1.0 + float(alpha) * (s - b)))


def staleness_weights(policy: str, staleness, alpha: float = 0.5,
                      hinge_b: int = 4) -> np.ndarray:
    """Array form of :func:`staleness_weight` over a staleness vector, in
    float32."""
    p = _check_policy(policy)
    s = np.asarray(staleness, np.float32)
    if p == "constant":
        return np.ones_like(s)
    if p == "polynomial":
        return (np.float32(1.0) + s) ** np.float32(-float(alpha))
    b = np.float32(float(hinge_b))
    return np.where(s <= b, np.float32(1.0),
                    np.float32(1.0) / (np.float32(1.0) + np.float32(float(alpha)) * (s - b))
                    ).astype(np.float32)
