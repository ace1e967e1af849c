"""Defense dispatcher singleton (counterpart of
``fedml_tpu/core/security/fedml_defender.py``).

Gated by ``enable_defense`` and ``defense_type``; the rules are
``defense_funcs``'s, over lists of ``(n, {name: tensor})``.  Hook protocol:

* before aggregation: filter or clip the raw update list;
* on aggregation: replace the aggregation rule;
* after aggregation: post-process the aggregate.

The simulator runs the stacked forms instead (``stacked.py``), which the
tests hold to these hooks.  The defender's draws (wbc, weak_dp) come in turn
from a generator seeded ``random_seed + 1013``.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional, Tuple

import torch

from ...models.convert import FlatLayout
from ...utils.rng import seeded_generator
from . import defense_funcs as F
from .constants import (
    DEFENSE_BULYAN,
    DEFENSE_CCLIP,
    DEFENSE_COORDINATE_WISE_MEDIAN,
    DEFENSE_COORDINATE_WISE_TRIMMED_MEAN,
    DEFENSE_FOOLSGOLD,
    DEFENSE_GEO_MEDIAN,
    DEFENSE_KRUM,
    DEFENSE_MULTI_KRUM,
    DEFENSE_NORM_DIFF_CLIPPING,
    DEFENSE_RFA,
    DEFENSE_ROBUST_LEARNING_RATE,
    DEFENSE_SLSGD,
    DEFENSE_SOTERIA,
    DEFENSE_THREE_SIGMA,
    DEFENSE_WBC,
    DEFENSE_WEAK_DP,
)

logger = logging.getLogger(__name__)

Updates = List[Tuple[float, Any]]
DEFENSE_SALT = 1013

_BEFORE_DEFENSES = {
    DEFENSE_KRUM,
    DEFENSE_MULTI_KRUM,
    DEFENSE_NORM_DIFF_CLIPPING,
    DEFENSE_THREE_SIGMA,
    DEFENSE_SOTERIA,  # client-side in the paper; applied to each shared update
    DEFENSE_WBC,  # client-side in the paper; applied to each shared update
}
_ON_DEFENSES = {
    DEFENSE_SLSGD,
    DEFENSE_GEO_MEDIAN,
    DEFENSE_RFA,
    DEFENSE_CCLIP,
    DEFENSE_FOOLSGOLD,
    DEFENSE_ROBUST_LEARNING_RATE,
    DEFENSE_COORDINATE_WISE_MEDIAN,
    DEFENSE_COORDINATE_WISE_TRIMMED_MEAN,
    DEFENSE_BULYAN,
}
_AFTER_DEFENSES = {DEFENSE_WEAK_DP}

SUPPORTED_DEFENSES = sorted(_BEFORE_DEFENSES | _ON_DEFENSES | _AFTER_DEFENSES)


class FedMLDefender:
    _defender_instance: Optional["FedMLDefender"] = None

    @classmethod
    def get_instance(cls) -> "FedMLDefender":
        if cls._defender_instance is None:
            cls._defender_instance = cls()
        return cls._defender_instance

    def __init__(self):
        self.is_enabled = False
        self.defense_type: Optional[str] = None
        self.args = None
        self._history: Optional[torch.Tensor] = None  # foolsgold per-client history
        self._wbc_prev = None
        self._soteria_probe = None
        self._gen = seeded_generator((DEFENSE_SALT,))

    def init(self, args: Any) -> None:
        if not getattr(args, "enable_defense", False):
            self.is_enabled = False
            return
        self.args = args
        self.is_enabled = True
        self.defense_type = str(args.defense_type).strip()
        self._history = None
        self._wbc_prev = None
        self._soteria_probe = None
        if self.defense_type not in SUPPORTED_DEFENSES:
            raise ValueError(
                f"unknown defense_type {self.defense_type!r}; supported: {SUPPORTED_DEFENSES}"
            )
        if self.defense_type == DEFENSE_WBC and int(
            getattr(args, "client_num_in_total", 0)
        ) != int(getattr(args, "client_num_per_round", 0)):
            # WBC compares each client's update to ITS OWN previous update;
            # the aggregation hook only sees positional slots, which map to
            # stable clients only under full participation — fail loudly
            # rather than comparing unrelated clients' updates.
            raise NotImplementedError(
                "defense 'wbc' requires full participation "
                "(client_num_per_round == client_num_in_total): per-client "
                "update history is keyed by round slot"
            )
        self._gen = seeded_generator((int(getattr(args, "random_seed", 0)) + DEFENSE_SALT,))
        logger.info("defense enabled: %s", self.defense_type)

    def is_defense_enabled(self) -> bool:
        return self.is_enabled

    def is_defense_before_aggregation(self) -> bool:
        return self.defense_type in _BEFORE_DEFENSES

    def is_defense_on_aggregation(self) -> bool:
        return self.defense_type in _ON_DEFENSES

    def is_defense_after_aggregation(self) -> bool:
        return self.defense_type in _AFTER_DEFENSES

    # -- hooks ---------------------------------------------------------------
    def defend_before_aggregation(self, raw_client_grad_list: Updates,
                                  extra_auxiliary_info: Any = None) -> Updates:
        if not self.is_defense_before_aggregation():
            return raw_client_grad_list
        a = self.args
        t = self.defense_type
        if t in (DEFENSE_KRUM, DEFENSE_MULTI_KRUM):
            return F.krum(
                raw_client_grad_list,
                byzantine_num=int(getattr(a, "byzantine_client_num", 1)),
                multi=(t == DEFENSE_MULTI_KRUM) or bool(getattr(a, "multi", False)),
                krum_param_m=int(getattr(a, "krum_param_m", 1)),
            )
        if t == DEFENSE_NORM_DIFF_CLIPPING:
            return F.norm_diff_clipping(raw_client_grad_list, extra_auxiliary_info,
                                        float(getattr(a, "norm_bound", 5.0)))
        if t == DEFENSE_THREE_SIGMA:
            return F.three_sigma_filter(raw_client_grad_list, extra_auxiliary_info)
        if t == DEFENSE_SOTERIA:
            return self._soteria(raw_client_grad_list, extra_auxiliary_info)
        return self._wbc(raw_client_grad_list, extra_auxiliary_info)

    # -- client-side defenses run over the shared-update list ----------------
    def register_soteria_probe(self, feature_fn: Callable, probe_data) -> None:
        """Install the representation function (one input -> its feature
        vector) and probe batch that Soteria scores sensitivities with, by
        ``torch.func`` Jacobians.  Without a probe, sensitivities fall back to
        a delta-magnitude proxy on the defended layer."""
        self._soteria_probe = (feature_fn, probe_data)

    def soteria_probe_mask(self) -> Optional[torch.Tensor]:
        """The registered probe's 0/1 feature mask (None without a probe)."""
        if self._soteria_probe is None:
            return None
        feature_fn, xs = self._soteria_probe
        return F.soteria_mask(F.soteria_scores(feature_fn, xs),
                              float(getattr(self.args, "soteria_percentile", 10.0)))

    def _soteria(self, updates: Updates, global_params: Any) -> Updates:
        a = self.args
        layer_path = getattr(a, "soteria_layer", ("classifier", "kernel"))
        pct = float(getattr(a, "soteria_percentile", 10.0))
        mask = self.soteria_probe_mask()
        layout = FlatLayout.of(global_params)
        g_vec = layout.ravel({k: v.float() for k, v in global_params.items()})
        out = []
        for n, p in updates:
            row = F.soteria_prune(layout.ravel(p)[None], g_vec, layout, layer_path, pct, mask)
            out.append((n, layout.unravel(row[0], p)))
        return out

    def _wbc(self, updates: Updates, global_params: Any) -> Updates:
        a = self.args
        strength = float(getattr(a, "wbc_strength", 1.0))
        lr = float(getattr(a, "wbc_lr", 0.1))
        prev = self._wbc_prev or {}
        out, new_prev = [], {}
        for i, (n, p) in enumerate(updates):
            new_prev[i] = p
            if i in prev:
                p = F.wbc_perturb(p, prev[i], self._gen, strength=strength, lr=lr)
            out.append((n, p))
        self._wbc_prev = new_prev
        return out

    def defend_on_aggregation(self, raw_client_grad_list: Updates,
                              base_aggregation_func: Callable = None,
                              extra_auxiliary_info: Any = None) -> Any:
        if not self.is_defense_on_aggregation():
            if base_aggregation_func is None:
                raise ValueError("base_aggregation_func required")
            return base_aggregation_func(self.args, raw_client_grad_list)
        a = self.args
        t = self.defense_type
        if t in (DEFENSE_GEO_MEDIAN, DEFENSE_RFA):
            return F.geometric_median(raw_client_grad_list,
                                      max_iter=int(getattr(a, "geo_median_max_iter", 10)))
        if t == DEFENSE_SLSGD:
            return F.slsgd(raw_client_grad_list, extra_auxiliary_info,
                           trim_count=int(getattr(a, "trim_param_b", 1)),
                           alpha=float(getattr(a, "alpha", 0.5)))
        if t == DEFENSE_CCLIP:
            return F.cclip(raw_client_grad_list, extra_auxiliary_info,
                           tau=float(getattr(a, "tau", 10.0)),
                           n_iter=int(getattr(a, "bucket_iter", 1)))
        if t == DEFENSE_FOOLSGOLD:
            mat, layout, _ = F._ravel_all(raw_client_grad_list)
            deltas = mat - layout.ravel(extra_auxiliary_info)[None, :]
            if self._history is None or self._history.shape != deltas.shape:
                self._history = deltas
            else:
                self._history = self._history + deltas
            return F.foolsgold(raw_client_grad_list, self._history)
        if t == DEFENSE_ROBUST_LEARNING_RATE:
            return F.robust_learning_rate(raw_client_grad_list, extra_auxiliary_info,
                                          threshold=int(getattr(a, "robust_threshold", 4)))
        if t == DEFENSE_COORDINATE_WISE_MEDIAN:
            return F.coordinate_wise_median(raw_client_grad_list)
        if t == DEFENSE_COORDINATE_WISE_TRIMMED_MEAN:
            return F.coordinate_wise_trimmed_mean(raw_client_grad_list,
                                                  float(getattr(a, "beta", 0.1)))
        return F.bulyan(raw_client_grad_list, int(getattr(a, "byzantine_client_num", 1)))

    def defend_after_aggregation(self, global_model: Any) -> Any:
        if not self.is_defense_after_aggregation():
            return global_model
        return F.weak_dp(global_model, float(getattr(self.args, "stddev", 0.025)), self._gen)

    def get_malicious_client_idxs(self) -> List[int]:
        return []
