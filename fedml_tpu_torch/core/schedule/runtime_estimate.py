"""Per-device linear runtime model fitted from observed training times.

Role of reference ``core/schedule/runtime_estimate.py`` (``t_sample_fit``):
model the time a device takes to train a client as ``t ≈ a·n_samples + b``
and report the relative fit error so callers can fall back to sample-count
scheduling when the model is unreliable.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


def linear_fit(x, y) -> Tuple[float, float, float]:
    """Least-squares ``y ≈ a·x + b``. Returns (a, b, mean relative error)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if len(x) < 2 or np.ptp(x) == 0:
        a = 0.0
        b = float(y.mean()) if len(y) else 0.0
    else:
        a, b = np.polyfit(x, y, 1)
    pred = a * x + b
    err = float(np.mean(np.abs(pred - y) / np.maximum(y, 1e-12))) if len(y) else 1.0
    return float(a), float(b), err


class RuntimeEstimator:
    """Accumulates (device, n_samples, seconds) observations and predicts
    per-client runtimes per device.

    ``uniform_devices=True`` pools all devices into one model — the right
    default on TPU where mesh slots are identical chips (unlike the
    reference's heterogeneous-GPU fleet)."""

    def __init__(self, num_devices: int, uniform_devices: bool = True):
        self.num_devices = num_devices
        self.uniform_devices = uniform_devices
        self._obs: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
        self._fits: Dict[int, Tuple[float, float, float]] = {}
        self._dirty = True

    def record(self, device_id: int, n_samples: int, seconds: float) -> None:
        key = 0 if self.uniform_devices else int(device_id)
        self._obs[key].append((float(n_samples), float(seconds)))
        self._dirty = True

    def _fit(self) -> None:
        self._fits = {}
        for key, obs in self._obs.items():
            xs, ys = zip(*obs)
            self._fits[key] = linear_fit(xs, ys)
        self._dirty = False

    def fit_error(self, device_id: int = 0) -> float:
        if self._dirty:
            self._fit()
        key = 0 if self.uniform_devices else int(device_id)
        return self._fits.get(key, (0.0, 0.0, 1.0))[2]

    def predict(self, device_id: int, n_samples: int) -> Optional[float]:
        """Predicted seconds for a client of ``n_samples`` on ``device_id``;
        None until at least one observation exists for that device."""
        if self._dirty:
            self._fit()
        key = 0 if self.uniform_devices else int(device_id)
        if key not in self._fits:
            return None
        a, b, _ = self._fits[key]
        return max(a * n_samples + b, 0.0)

    def predict_marginal(self, device_id: int, n_samples: int) -> Optional[float]:
        """Marginal (size-dependent) seconds ``a·n`` WITHOUT the intercept.

        The intercept absorbs per-observation fixed overhead (dispatch, eval,
        collectives) that is paid once per round, not once per client — so
        relative per-client costs for scheduling must exclude it, or every
        client costs ~b and load balancing degenerates to count-balancing.
        Returns None when no model exists or the fitted slope is non-positive
        (degenerate fit — caller should fall back to sample counts)."""
        if self._dirty:
            self._fit()
        key = 0 if self.uniform_devices else int(device_id)
        if key not in self._fits:
            return None
        a, _, _ = self._fits[key]
        if a <= 0.0:
            return None
        return a * n_samples

    def has_model(self) -> bool:
        return bool(self._obs)
