"""Robust-aggregation defense math (counterpart of
``fedml_tpu/core/security/defense_funcs.py``).

Each list rule takes ``updates: List[(sample_num, variables)]`` and either
filters the list (before-aggregation defenses) or replaces the aggregation
rule (on-aggregation defenses).  Distance-based rules lay each update out as
one fp32 vector in ``ravel_pytree`` order (``models.convert.FlatLayout``)
and work on the ``[n, D]`` matrix; the matrix primitives here
(``pairwise_sq_dists``, ``krum_scores``, ``median_rows``, ``trimmed_mean_rows``,
``foolsgold_weights``, ``laplace_from_uniform``, ``soteria_mask``) also serve
the stacked forms (``stacked.py``).

Three points keep the port on the JAX package's numbers:

* distances take the Gram form ``|a|^2 + |b|^2 - 2 a.b`` clamped at 0, with
  the product by ``torch.matmul`` in full fp32 (the simulator turns TF32 off
  on the card), not ``torch.cdist``;
* the coordinate-wise median averages the two middle values when ``n`` is
  even, as ``jnp.median`` does ((lo + hi) * 0.5), from a sort: ``torch.median``
  returns the lower one, and ``torch.quantile`` refuses inputs of 2^24
  elements and more;
* every ``argsort`` is stable, as ``jnp.argsort`` is.

Random rules are a draw and a function of it: ``weak_dp`` and
``wbc_perturb`` take their draw as ``noise``, or draw it from ``gen``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ...models.convert import FlatLayout
from ..aggregate import weighted_mean  # noqa: F401  (re-exported: the rules' base aggregate)
from ..dp.mechanisms import apply as apply_noise

Tree = Dict[str, torch.Tensor]
Updates = List[Tuple[float, Tree]]

# wbc's Laplace draw: jax.random.uniform on [-0.5 + 1e-7, 0.5)
_WBC_LOW, _WBC_HIGH = -0.5 + 1e-7, 0.5


def _ravel_all(updates: Sequence[Tuple[float, Tree]]):
    """-> (matrix [n, D], layout, sample counts [n])."""
    layout = FlatLayout.of(updates[0][1])
    mat = torch.stack([layout.ravel(p) for _, p in updates], 0)
    nums = torch.tensor([float(n) for n, _ in updates], dtype=torch.float32, device=mat.device)
    return mat, layout, nums


def _unravel(layout: FlatLayout, vec: torch.Tensor, like: Tree) -> Tree:
    return layout.unravel(vec, like)


# ---------------------------------------------------------------------------
# matrix primitives
# ---------------------------------------------------------------------------
def pairwise_sq_dists(mat: torch.Tensor) -> torch.Tensor:
    """[n, d] -> [n, n] squared euclidean distances by the Gram form."""
    sq = torch.sum(mat * mat, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * torch.matmul(mat, mat.T)
    return torch.clamp_min(d2, 0.0)


def krum_scores(mat: torch.Tensor, byzantine_num: int) -> torch.Tensor:
    n = mat.shape[0]
    d2 = pairwise_sq_dists(mat)
    d2 = d2 + torch.diag(torch.full((n,), float("inf"), device=mat.device))
    k = max(n - byzantine_num - 2, 1)
    nearest = torch.sort(d2, dim=1).values[:, :k]
    return torch.sum(nearest, dim=1)


def argsort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.argsort(x, dim=dim, stable=True)


def median_rows(mat: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over dim 0, the mean of the two middle values
    when the row count is even (``jnp.median``)."""
    n = mat.shape[0]
    srt = torch.sort(mat, dim=0).values
    lo, hi = srt[(n - 1) // 2], srt[n // 2]
    return (lo + hi) * 0.5


def trimmed_mean_rows(mat: torch.Tensor, k: int) -> torch.Tensor:
    """Sort each coordinate, drop ``k`` values at each end, average the rest."""
    n = mat.shape[0]
    srt = torch.sort(mat, dim=0).values
    return torch.mean(srt[k:n - k], dim=0)


def laplace_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """wbc's Laplace sample from ``u`` on [-0.5 + 1e-7, 0.5):
    -sign(u) * log1p(-2 |u|)."""
    return -torch.sign(u) * torch.log1p(-2.0 * u.abs())


def wbc_uniform(shape, gen: torch.Generator, device) -> torch.Tensor:
    """The uniform draw ``laplace_from_uniform`` takes."""
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (u * (_WBC_HIGH - _WBC_LOW) + _WBC_LOW).clamp_min_(_WBC_LOW).to(device)


def foolsgold_weights(history_mat: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """[n, d] aggregate historical updates -> per-client learning weights."""
    norms = torch.linalg.vector_norm(history_mat, dim=1, keepdim=True)
    normed = history_mat / torch.clamp_min(norms, eps)
    n = history_mat.shape[0]
    cs = torch.matmul(normed, normed.T) - torch.eye(n, device=history_mat.device)
    maxcs = torch.max(cs, dim=1).values
    # pardoning: when maxcs[i] < maxcs[j], rescale cs[i, j] by maxcs[i]/maxcs[j]
    # so honest clients (low max-similarity) are pardoned, sybils are not
    scaled = cs * torch.clamp_max(maxcs[:, None] / torch.clamp_min(maxcs[None, :], eps), 1.0)
    wv = 1.0 - torch.max(scaled, dim=1).values
    wv = torch.clamp(wv, 0.0, 1.0)
    wv = wv / torch.clamp_min(torch.max(wv), eps)
    wv = torch.where(wv == 1.0, torch.full_like(wv, 0.99), wv)
    logits = torch.log(torch.clamp_min(wv / torch.clamp_min(1.0 - wv, eps), eps)) + 0.5
    return torch.clamp(logits, 0.0, 1.0)


def soteria_mask(scores: torch.Tensor, percentile: float = 1.0) -> torch.Tensor:
    """0/1 mask keeping the features at or above the given percentile of
    sensitivity (linear interpolation, as ``jnp.percentile``), along the last
    axis."""
    thresh = torch.quantile(scores, float(percentile) / 100.0, dim=-1, keepdim=True)
    return (scores >= thresh).float()


def soteria_scores(feature_fn: Callable[[torch.Tensor], torch.Tensor],
                   xs: torch.Tensor) -> torch.Tensor:
    """Per-feature sensitivity ||dr_f/dx|| / |r_f| summed over a probe batch:
    one ``torch.func.jacrev`` a sample, vmapped.  ``feature_fn``: one input ->
    its representation vector [F]."""
    from torch.func import jacrev, vmap

    def per_sample(x):
        r = feature_fn(x)
        jac = jacrev(feature_fn)(x)  # [F, *x.shape]
        jn = torch.sqrt(torch.sum(jac.reshape(jac.shape[0], -1) ** 2, dim=1))
        return jn / torch.clamp_min(r.abs(), 1e-8)

    return torch.sum(vmap(per_sample)(xs), dim=0)


def soteria_columns(layout: FlatLayout, layer_path) -> Tuple[int, Tuple[int, ...]]:
    """(first column, flax shape) of the defended layer in the flat layout.
    ``layer_path`` is its flax path under ``params`` (a sequence, or a string
    with ``/``) or the port's parameter name (a string with ``.``)."""
    if isinstance(layer_path, str):
        if "." in layer_path:  # the port's parameter name
            entry = next((e for e in layout.entries if e[0] == layer_path), None)
            if entry is None:
                raise KeyError(f"no parameter {layer_path}")
            return entry[4], entry[3]
        layer_path = layer_path.split("/")
    entry = layout.entry(tuple(layer_path))
    return entry[4], entry[3]


def soteria_prune(mat: torch.Tensor, g_vec: torch.Tensor, layout: FlatLayout, layer_path,
                  pct: float, probe_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Rows of ``mat`` with the pruned representation features of the
    defended layer's delta masked out (its feature axis is the flax leaf's
    last); the other columns are returned as they are.  The mask comes from
    the probe when there is one, else from each row's per-feature delta
    magnitude."""
    off, fshape = soteria_columns(layout, layer_path)
    size = math.prod(fshape)
    n, feat = mat.shape[0], fshape[-1]
    node = mat[:, off:off + size].reshape(n, -1, feat)
    gnode = g_vec[off:off + size].reshape(1, -1, feat)
    delta = node - gnode
    if probe_mask is not None:
        mask = probe_mask.float().reshape(1, feat).expand(n, feat)
    else:
        mag = torch.sqrt(torch.sum(delta ** 2, dim=1))
        mask = soteria_mask(mag, pct)
    out = mat.clone()
    out[:, off:off + size] = (gnode + delta * mask[:, None, :]).reshape(n, size)
    return out


# ---------------------------------------------------------------------------
# list rules
# ---------------------------------------------------------------------------
def krum(updates: Updates, byzantine_num: int, multi: bool = False,
         krum_param_m: int = 1) -> Updates:
    mat, _, _ = _ravel_all(updates)
    scores = krum_scores(mat, byzantine_num)
    m = max(int(krum_param_m), 1) if multi else 1
    chosen = argsort(scores)[:m]
    return [updates[int(i)] for i in chosen]


def coordinate_wise_median(updates: Updates) -> Tree:
    mat, layout, _ = _ravel_all(updates)
    return _unravel(layout, median_rows(mat), updates[0][1])


def coordinate_wise_trimmed_mean(updates: Updates, trim_ratio: float) -> Tree:
    n = len(updates)
    return _trimmed_mean_count(updates, int(n * float(trim_ratio)))


def _trimmed_mean_count(updates: Updates, k: int) -> Tree:
    """Trim ``k`` updates per coordinate per end, then average the rest."""
    n = len(updates)
    k = max(0, min(int(k), (n - 1) // 2))
    mat, layout, _ = _ravel_all(updates)
    return _unravel(layout, trimmed_mean_rows(mat, k), updates[0][1])


def geometric_median(updates: Updates, max_iter: int = 10, eps: float = 1e-8) -> Tree:
    """Weiszfeld iterations from the weighted mean."""
    mat, layout, nums = _ravel_all(updates)
    w = nums / torch.sum(nums)
    z = torch.sum(w[:, None] * mat, dim=0)
    for _ in range(int(max_iter)):
        dist = torch.linalg.vector_norm(mat - z[None, :], dim=1)
        inv = w / torch.clamp_min(dist, eps)
        z = torch.sum(inv[:, None] * mat, dim=0) / torch.sum(inv)
    return _unravel(layout, z, updates[0][1])


def norm_diff_clipping(updates: Updates, global_params: Tree, norm_bound: float) -> Updates:
    """Clip each client's delta from the global model to norm <= bound."""
    layout = FlatLayout.of(global_params)
    g_vec = layout.ravel(global_params)
    out: Updates = []
    for n, p in updates:
        diff = layout.ravel(p) - g_vec
        nrm = torch.linalg.vector_norm(diff)
        scale = torch.clamp_max(norm_bound / torch.clamp_min(nrm, 1e-12), 1.0)
        out.append((n, _unravel(layout, g_vec + diff * scale, p)))
    return out


def cclip(updates: Updates, global_params: Tree, tau: float = 10.0, n_iter: int = 1) -> Tree:
    """Centered clipping: iterate v <- v + mean(clip(x_i - v, tau))."""
    mat, layout, nums = _ravel_all(updates)
    w = nums / torch.sum(nums)
    v = layout.ravel(global_params)
    for _ in range(int(n_iter)):
        diff = mat - v[None, :]
        nrm = torch.linalg.vector_norm(diff, dim=1, keepdim=True)
        scale = torch.clamp_max(tau / torch.clamp_min(nrm, 1e-12), 1.0)
        v = v + torch.sum(w[:, None] * diff * scale, dim=0)
    return _unravel(layout, v, global_params)


def weak_dp(aggregated: Tree, stddev: float, gen: Optional[torch.Generator] = None,
            noise: Optional[Tree] = None) -> Tree:
    """Gaussian noise of ``stddev`` on every floating leaf; ``noise`` is the
    standard-normal draw (drawn from ``gen`` when absent)."""
    if noise is None:
        noise = {k: torch.randn(v.shape, generator=gen, device=gen.device,
                                dtype=torch.float32).to(v.device)
                 for k, v in aggregated.items() if v.is_floating_point()}
    return apply_noise(aggregated, {k: stddev * z for k, z in noise.items()})


def slsgd(updates: Updates, global_params: Tree, trim_count: int, alpha: float) -> Tree:
    """Trimmed mean (``trim_count`` updates per end), then a step of
    ``alpha`` from the global model towards it."""
    agg = _trimmed_mean_count(updates, trim_count)
    return {k: global_params[k].float() * (1.0 - alpha) + agg[k] * alpha for k in agg}


def foolsgold(updates: Updates, history_mat: torch.Tensor) -> Tree:
    mat, layout, _ = _ravel_all(updates)
    wv = foolsgold_weights(history_mat)
    wv = wv / torch.clamp_min(torch.sum(wv), 1e-12)
    return _unravel(layout, torch.sum(wv[:, None] * mat, dim=0), updates[0][1])


def robust_learning_rate(updates: Updates, global_params: Tree, threshold: int) -> Tree:
    mat, layout, nums = _ravel_all(updates)
    g_vec = layout.ravel(global_params)
    dmat = mat - g_vec[None, :]
    w = nums / torch.sum(nums)
    sign_agreement = torch.abs(torch.sum(torch.sign(dmat), dim=0))
    lr = torch.where(sign_agreement >= threshold, 1.0, -1.0)
    avg_delta = torch.sum(w[:, None] * dmat, dim=0)
    return _unravel(layout, g_vec + lr * avg_delta, global_params)


def bulyan(updates: Updates, byzantine_num: int) -> Tree:
    """Multi-krum selection of n - 2f, then per coordinate the mean of the
    n - 4f values closest to the selection's median."""
    n = len(updates)
    theta = max(n - 2 * byzantine_num, 1)
    mat, layout, _ = _ravel_all(updates)
    return _unravel(layout, bulyan_rows(mat, byzantine_num, theta), updates[0][1])


def bulyan_rows(mat: torch.Tensor, byzantine_num: int, theta: int) -> torch.Tensor:
    scores = krum_scores(mat, byzantine_num)
    return bulyan_trim(mat[argsort(scores)[:theta]], byzantine_num, theta)


def bulyan_trim(sel_mat: torch.Tensor, byzantine_num: int, theta: int) -> torch.Tensor:
    """Bulyan's second stage on the krum-selected rows: per coordinate the
    mean of the theta - 2f values closest to their median."""
    beta = max(theta - 2 * byzantine_num, 1)
    med = median_rows(sel_mat)
    order = argsort(torch.abs(sel_mat - med[None, :]), dim=0)[:beta]
    return torch.mean(torch.gather(sel_mat, 0, order), dim=0)


def three_sigma_filter(updates: Updates, global_params: Tree) -> Updates:
    mat, layout, _ = _ravel_all(updates)
    arr = torch.linalg.vector_norm(mat - layout.ravel(global_params)[None, :], dim=1)
    mu, sigma = torch.mean(arr), torch.std(arr, correction=0)
    mask = torch.abs(arr - mu) <= 3.0 * sigma + 1e-12
    keep = [i for i, ok in enumerate(mask.tolist()) if ok]
    return [updates[i] for i in keep] or updates


def soteria_apply(update: Tree, global_params: Tree, mask: torch.Tensor, layer_path) -> Tree:
    """Mask the pruned representation features out of a client's delta on
    the defended layer, leaving the rest of the update untouched."""
    layout = FlatLayout.of(global_params)
    g_vec = layout.ravel(global_params)
    out = soteria_prune(layout.ravel(update)[None], g_vec, layout, layer_path, 0.0, mask)
    return _unravel(layout, out[0], update)


def wbc_perturb(update: Tree, prev_update: Tree, gen: Optional[torch.Generator] = None,
                strength: float = 1.0, lr: float = 0.1,
                noise: Optional[torch.Tensor] = None) -> Tree:
    """Laplace noise where the update barely moved since the previous round
    (|delta - prev| <= |noise|); ``noise`` is the uniform draw of
    ``laplace_from_uniform`` ([D], drawn from ``gen`` when absent)."""
    layout = FlatLayout.of(update)
    vec = layout.ravel(update)
    diff = vec - layout.ravel(prev_update)
    if noise is None:
        noise = wbc_uniform(vec.shape, gen, vec.device)
    lap = strength * laplace_from_uniform(noise)
    lap = torch.where(torch.abs(diff) > torch.abs(lap), torch.zeros_like(lap), lap)
    return _unravel(layout, vec + lr * lap, update)

