"""Stacked (client-axis) attack and defense math of the round's security
tail (counterpart of ``fedml_tpu/core/security/stacked.py``).

The round stacks its clients' final variables into one ``[n, D]`` fp32
matrix on the card, in the coordinate order of ``jax.flatten_util.
ravel_pytree`` over the flax tree (``models.convert.FlatLayout``), so a row
is the JAX package's row column for column.  Every attack and defense is a
function of that matrix:

* ``build_stacked_attack``: the model attacks (byzantine, model
  replacement, ALIE, the edge-case projection) as row edits gated by a
  malicious-slot mask;
* ``build_stacked_defense``: every robust-aggregation rule, in tree mode
  ``(stack, w, global, gen, state) -> (aggregate, state)`` or, with
  ``rows=True``, rows mode ``-> (rows', w', state)``: the defended row space
  of the strategies that aggregate through ``ext`` (FedNova, the async
  ones), whose weighted mean is always the tree-mode aggregate.

``stack`` is a ``{name: [n, ...]}`` dict or the ``[n, D]`` matrix itself.
The random rules (byzantine ``random``, weak_dp, wbc) are a draw and a
function of it: each takes its draw as ``noise`` or draws it from ``gen``
(``attack.draw`` / ``defense.draw`` give the draw on its own), so a test can
feed ``jax.random``'s draw through the port's arithmetic.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ...models.convert import FlatLayout
from . import defense_funcs as F
from .constants import (
    ATTACK_METHOD_BACKDOOR,
    ATTACK_METHOD_BYZANTINE_ATTACK,
    ATTACK_METHOD_EDGE_CASE_BACKDOOR,
    ATTACK_METHOD_MODEL_REPLACEMENT,
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

Tree = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]


def stack_to_mat(stack: Any) -> torch.Tensor:
    """``{name: [n, ...]}`` -> the ``[n, D]`` fp32 matrix in ``ravel_pytree``
    order (a matrix passes through)."""
    if torch.is_tensor(stack):
        return stack
    return FlatLayout.of(stack, lead=1).stack_to_mat(stack)


def flat_dim(tree: Tree) -> int:
    return sum(int(v.numel()) for v in tree.values())


def _wmean(mat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(w, mat) / torch.clamp_min(torch.sum(w), 1e-9)


def _global_vec(global_vars: Tree):
    layout = FlatLayout.of(global_vars)
    return layout, layout.ravel({k: v.float() for k, v in global_vars.items()})


# ---------------------------------------------------------------------------
# attacks
# ---------------------------------------------------------------------------
class StackedAttack:
    """``attack(mat, w, g_vec, mal, gen=None, noise=None) -> mat'``, ``mal``
    the ``[n]`` 0/1 malicious-slot mask (drawn on the host over the
    population, so it matches the data-poisoning targets)."""

    def __init__(self, args, attack_type: str):
        self.attack_type = attack_type
        # one knob, two defaults: byzantine's mode and ALIE's
        self.mode = str(getattr(args, "attack_mode", "random"))
        self.alie_mode = str(getattr(args, "attack_mode", "craft"))
        self.scale = float(getattr(args, "attack_scale", 10.0))
        self.num_std = float(getattr(args, "attack_num_std", 1.5))
        self.eps = float(getattr(args, "attack_norm_bound", 5.0))
        if attack_type not in (ATTACK_METHOD_BYZANTINE_ATTACK, ATTACK_METHOD_MODEL_REPLACEMENT,
                               ATTACK_METHOD_BACKDOOR, ATTACK_METHOD_EDGE_CASE_BACKDOOR):
            raise NotImplementedError(f"attack {attack_type!r} has no stacked form")
        if attack_type == ATTACK_METHOD_BYZANTINE_ATTACK and self.mode not in (
                "zero", "random", "flip"):
            raise ValueError(f"unknown byzantine mode {self.mode!r}")

    @property
    def random(self) -> bool:
        return self.attack_type == ATTACK_METHOD_BYZANTINE_ATTACK and self.mode == "random"

    def draw(self, shape, gen: torch.Generator, device) -> Optional[torch.Tensor]:
        """The standard-normal garbage of byzantine ``random``; None for the
        deterministic attacks."""
        if not self.random:
            return None
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    def __call__(self, mat, w, g_vec, mal, gen=None, noise=None) -> torch.Tensor:
        m = mal[:, None] > 0
        g = g_vec[None, :]
        t = self.attack_type
        if t == ATTACK_METHOD_BYZANTINE_ATTACK:
            if self.mode == "zero":
                bad = torch.zeros_like(mat)
            elif self.mode == "random":
                bad = noise if noise is not None else self.draw(mat.shape, gen, mat.device)
            else:  # flip
                bad = 2.0 * g - mat
            return torch.where(m, bad, mat)
        if t == ATTACK_METHOD_MODEL_REPLACEMENT:
            return torch.where(m, g + self.scale * (mat - g), mat)
        if t == ATTACK_METHOD_BACKDOOR:
            # ALIE in-range evasion over the benign rows' (unweighted) statistics
            benign = (1.0 - mal)[:, None]
            den = torch.clamp_min(torch.sum(1.0 - mal), 1.0)
            mean = torch.sum(mat * benign, 0) / den
            var = torch.sum(((mat - mean[None, :]) ** 2) * benign, 0) / den
            std = torch.sqrt(var)
            lo, hi = mean - self.num_std * std, mean + self.num_std * std
            if self.alie_mode == "clip":
                bad = torch.minimum(torch.maximum(mat, lo[None, :]), hi[None, :])
            else:  # craft
                bad = lo[None, :].expand_as(mat)
            return torch.where(m, bad, mat)
        # edge-case backdoor: the scaled push, projected into the eps-ball
        delta = self.scale * (mat - g)
        nrm = torch.linalg.vector_norm(delta, dim=1, keepdim=True)
        delta = delta * torch.clamp_max(self.eps / torch.clamp_min(nrm, 1e-12), 1.0)
        return torch.where(m, g + delta, mat)


def build_stacked_attack(args, attack_type: str) -> StackedAttack:
    return StackedAttack(args, attack_type)


# ---------------------------------------------------------------------------
# defenses
# ---------------------------------------------------------------------------
def init_defense_state(defense_type: Optional[str], n: int, d: int, device="cpu") -> State:
    """Cross-round defense state (foolsgold's history, wbc's previous rows)."""
    if defense_type == DEFENSE_FOOLSGOLD:
        return {"fg_hist": torch.zeros((n, d), dtype=torch.float32, device=device)}
    if defense_type == DEFENSE_WBC:
        return {"wbc_prev": torch.zeros((n, d), dtype=torch.float32, device=device),
                "wbc_has": torch.zeros((), dtype=torch.float32, device=device)}
    return {}


class StackedDefense:
    """One robust-aggregation rule over the ``[n, D]`` row space.

    ``rows_fn(mat, w, g_vec, gen, state, noise, rows_mode)`` is the rule:
    ``(mat', w', state)`` whose weighted mean ``_wmean(mat', w')`` is the
    aggregate.  ``rows_mode``: the output feeds an ext strategy's per-client
    recomputation, so its weights keep the sample-count scale (only
    foolsgold differs: it then broadcasts its aggregate instead of returning
    its trust weights).  Calling the object is the tree or rows API of
    ``build_stacked_defense``."""

    def __init__(self, args, defense_type: str, probe_mask: Optional[torch.Tensor] = None,
                 rows: bool = False):
        a = args
        self.t = defense_type
        self.rows = rows
        self.probe_mask = probe_mask
        self.byz = int(getattr(a, "byzantine_client_num", 1))
        self.multi = (defense_type == DEFENSE_MULTI_KRUM) or bool(getattr(a, "multi", False))
        self.krum_m = max(int(getattr(a, "krum_param_m", 1)), 1)
        self.norm_bound = float(getattr(a, "norm_bound", 5.0))
        self.wbc_strength = float(getattr(a, "wbc_strength", 1.0))
        self.wbc_lr = float(getattr(a, "wbc_lr", 0.1))
        self.geo_iter = int(getattr(a, "geo_median_max_iter", 10))
        self.tau = float(getattr(a, "tau", 10.0))
        self.bucket_iter = int(getattr(a, "bucket_iter", 1))
        self.trim_b = int(getattr(a, "trim_param_b", 1))
        self.alpha = float(getattr(a, "alpha", 0.5))
        self.threshold = int(getattr(a, "robust_threshold", 4))
        self.beta = float(getattr(a, "beta", 0.1))
        self.stddev = float(getattr(a, "stddev", 0.025))
        self.soteria_layer = getattr(a, "soteria_layer", ("classifier", "kernel"))
        self.soteria_pct = float(getattr(a, "soteria_percentile", 10.0))
        if defense_type not in _DEFENSES:
            raise NotImplementedError(f"defense {defense_type!r} has no stacked form")

    def draw(self, n: int, d: int, gen: torch.Generator, device) -> Optional[torch.Tensor]:
        """The rule's draw: wbc's uniform ``[n, D]``, weak_dp's standard
        normal ``[D]``; None for the deterministic rules."""
        if self.t == DEFENSE_WBC:
            return F.wbc_uniform((n, d), gen, device)
        if self.t == DEFENSE_WEAK_DP:
            return torch.randn((d,), generator=gen, device=device, dtype=torch.float32)
        return None

    def rows_fn(self, mat, w, g_vec, gen, state, noise=None, rows_mode=False, layout=None):
        t = self.t
        n = mat.shape[0]

        def bcast(vec):
            return vec[None, :].expand(mat.shape)

        if noise is None and t in (DEFENSE_WBC, DEFENSE_WEAK_DP):
            noise = self.draw(n, mat.shape[1], gen, mat.device)
        if t in (DEFENSE_KRUM, DEFENSE_MULTI_KRUM):
            m = self.krum_m if self.multi else 1
            chosen = F.argsort(F.krum_scores(mat, self.byz))[:m]
            sel = torch.zeros((n,), dtype=torch.float32, device=mat.device)
            sel[chosen] = 1.0
            return mat, w * sel, state
        if t == DEFENSE_NORM_DIFF_CLIPPING:
            diff = mat - g_vec[None, :]
            nrm = torch.linalg.vector_norm(diff, dim=1, keepdim=True)
            scale = torch.clamp_max(self.norm_bound / torch.clamp_min(nrm, 1e-12), 1.0)
            return g_vec[None, :] + diff * scale, w, state
        if t == DEFENSE_THREE_SIGMA:
            arr = torch.linalg.vector_norm(mat - g_vec[None, :], dim=1)
            mu, sigma = torch.mean(arr), torch.std(arr, correction=0)
            keep = (torch.abs(arr - mu) <= 3.0 * sigma + 1e-12).float()
            # all-outlier fallback: keep every row
            return mat, torch.where(torch.sum(keep) > 0, w * keep, w), state
        if t == DEFENSE_WBC:
            lap = self.wbc_strength * F.laplace_from_uniform(noise)
            diff = mat - state["wbc_prev"]
            lap = torch.where(torch.abs(diff) > torch.abs(lap), torch.zeros_like(lap), lap)
            pert = mat + self.wbc_lr * lap * state["wbc_has"]  # first round: no prev
            return pert, w, {"wbc_prev": mat.clone(), "wbc_has": torch.ones_like(state["wbc_has"])}
        if t in (DEFENSE_GEO_MEDIAN, DEFENSE_RFA):
            wn = w / torch.sum(w)
            z = torch.matmul(wn, mat)
            for _ in range(self.geo_iter):
                dist = torch.linalg.vector_norm(mat - z[None, :], dim=1)
                inv = wn / torch.clamp_min(dist, 1e-8)
                z = (inv[:, None] * mat).sum(0) / torch.sum(inv)
            return bcast(z), w, state
        if t == DEFENSE_CCLIP:
            wn = w / torch.sum(w)
            v = g_vec
            for _ in range(self.bucket_iter):
                diff = mat - v[None, :]
                nrm = torch.linalg.vector_norm(diff, dim=1, keepdim=True)
                s = torch.clamp_max(self.tau / torch.clamp_min(nrm, 1e-12), 1.0)
                v = v + torch.sum(wn[:, None] * diff * s, 0)
            return bcast(v), w, state
        if t == DEFENSE_SLSGD:
            b = max(0, min(self.trim_b, (n - 1) // 2))
            agg = F.trimmed_mean_rows(mat, b)
            return bcast((1.0 - self.alpha) * g_vec + self.alpha * agg), w, state
        if t == DEFENSE_FOOLSGOLD:
            hist = state["fg_hist"] + (mat - g_vec[None, :])
            wv = F.foolsgold_weights(hist)
            wv = wv / torch.clamp_min(torch.sum(wv), 1e-12)
            if rows_mode:
                return bcast(torch.matmul(wv, mat)), w, {"fg_hist": hist}
            return mat, wv, {"fg_hist": hist}
        if t == DEFENSE_ROBUST_LEARNING_RATE:
            deltas = mat - g_vec[None, :]
            wn = w / torch.sum(w)
            agree = torch.abs(torch.sum(torch.sign(deltas), dim=0))
            lr = torch.where(agree >= self.threshold, 1.0, -1.0)
            return bcast(g_vec + lr * torch.matmul(wn, deltas)), w, state
        if t == DEFENSE_COORDINATE_WISE_MEDIAN:
            return bcast(F.median_rows(mat)), w, state
        if t == DEFENSE_COORDINATE_WISE_TRIMMED_MEAN:
            k = max(0, min(int(n * self.beta), (n - 1) // 2))
            return bcast(F.trimmed_mean_rows(mat, k)), w, state
        if t == DEFENSE_BULYAN:
            return bcast(F.bulyan_rows(mat, self.byz, max(n - 2 * self.byz, 1))), w, state
        if t == DEFENSE_WEAK_DP:
            return bcast(_wmean(mat, w) + self.stddev * noise), w, state
        # soteria: the defended layer's pruned features per row
        return (F.soteria_prune(mat, g_vec, layout, self.soteria_layer, self.soteria_pct,
                                self.probe_mask), w, state)

    def aggregate(self, mat, w, g_vec, gen, state, noise=None, layout=None):
        """Tree mode on the matrix: ``(aggregate [D], state)``."""
        mat2, w2, state = self.rows_fn(mat, w, g_vec, gen, state, noise, layout=layout)
        return _wmean(mat2, w2), state

    def __call__(self, stack, w, global_vars, gen, state, noise=None):
        layout, g_vec = _global_vec(global_vars)
        mat = stack_to_mat(stack)
        if self.rows:
            return self.rows_fn(mat, w, g_vec, gen, state, noise, rows_mode=True, layout=layout)
        agg, state = self.aggregate(mat, w, g_vec, gen, state, noise, layout=layout)
        return layout.unravel(agg, global_vars), state


_DEFENSES = (DEFENSE_KRUM, DEFENSE_MULTI_KRUM, DEFENSE_NORM_DIFF_CLIPPING, DEFENSE_THREE_SIGMA,
             DEFENSE_WBC, DEFENSE_GEO_MEDIAN, DEFENSE_RFA, DEFENSE_CCLIP, DEFENSE_SLSGD,
             DEFENSE_FOOLSGOLD, DEFENSE_ROBUST_LEARNING_RATE, DEFENSE_COORDINATE_WISE_MEDIAN,
             DEFENSE_COORDINATE_WISE_TRIMMED_MEAN, DEFENSE_BULYAN, DEFENSE_WEAK_DP,
             DEFENSE_SOTERIA)


def build_stacked_defense(args, defense_type: str, probe_mask: Optional[torch.Tensor] = None,
                          rows: bool = False) -> StackedDefense:
    """-> ``defend(stack, w, global_vars, gen, state, noise=None)``: in tree
    mode ``(aggregate {name: fp32}, state)``; with ``rows=True`` the defended
    row space ``(mat', w', state)``."""
    return StackedDefense(args, defense_type, probe_mask=probe_mask, rows=rows)


def _soteria_stacked(stack, global_vars: Tree, layer_path, pct: float,
                     probe_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The stacked soteria pruning of every row (``[n, D]``)."""
    layout, g_vec = _global_vec(global_vars)
    return F.soteria_prune(stack_to_mat(stack), g_vec, layout, layer_path, pct, probe_mask)
