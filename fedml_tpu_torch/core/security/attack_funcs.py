"""Attack simulations over client updates and client data (counterpart of
``fedml_tpu/core/security/attack_funcs.py``).

* byzantine (zero / random / flip modes);
* label flipping (poison a dataset's labels);
* model replacement (the scaled malicious push);
* backdoor: trigger-pattern data poisoning and ALIE in-range evasion;
* edge-case backdoor: tail-sample relabeling and the norm-ball projection.

Updates are ``(sample_num, {name: tensor})`` pairs; data are tensors, images
NHWC.  The random choices (byzantine ``random``'s garbage, the backdoor's
rows) are arguments with a generator-drawn default, so a test can pass the
JAX package's.  The analysis attacks (DLG, gradient inversion, revealing
labels) are not ported (ROADMAP.md queue A, item 8: the trust path, what is left).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ...models.convert import FlatLayout

Tree = Dict[str, torch.Tensor]
Updates = List[Tuple[float, Tree]]


# ---------------------------------------------------------------------------
# Byzantine
# ---------------------------------------------------------------------------
def byzantine_attack(
    updates: Updates,
    global_params: Tree,
    byzantine_idxs: Sequence[int],
    mode: str,
    gen: Optional[torch.Generator] = None,
    noise: Optional[Sequence[Tree]] = None,
) -> Updates:
    """Corrupt the updates at ``byzantine_idxs``: ``zero`` a zero update,
    ``random`` standard-normal garbage (``noise[j]`` for the j-th malicious
    update, drawn from ``gen`` when absent), ``flip`` the push away from the
    global model, g - (x - g)."""
    out = list(updates)
    for j, i in enumerate(byzantine_idxs):
        n, p = updates[i]
        if mode == "zero":
            bad = {k: torch.zeros_like(v) for k, v in p.items()}
        elif mode == "random":
            bad = noise[j] if noise is not None else {
                k: torch.randn(v.shape, generator=gen, device=gen.device,
                               dtype=torch.float32).to(v.device)
                for k, v in p.items()}
        elif mode == "flip":
            bad = {k: 2.0 * global_params[k] - v for k, v in p.items()}
        else:
            raise ValueError(f"unknown byzantine mode {mode!r}")
        out[i] = (n, bad)
    return out


# ---------------------------------------------------------------------------
# Label flipping (data poisoning)
# ---------------------------------------------------------------------------
def flip_labels(labels: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    return torch.where(labels == src, torch.full_like(labels, dst), labels)


# ---------------------------------------------------------------------------
# Model replacement (scaled malicious push; backdoor core step)
# ---------------------------------------------------------------------------
def model_replacement(malicious_params: Tree, global_params: Tree, scale: float) -> Tree:
    """x_adv = g + scale * (x_mal - g): survives averaging with 1/scale dilution."""
    return {k: g + scale * (malicious_params[k] - g) for k, g in global_params.items()}


# ---------------------------------------------------------------------------
# Backdoor: trigger-pattern data poisoning + ALIE model-side evasion
# ---------------------------------------------------------------------------
def add_backdoor_pattern(x: torch.Tensor, size: int = 5, value: float = 2.8) -> torch.Tensor:
    """Stamp a corner trigger patch on a batch of NHWC images."""
    out = x.clone()
    out[:, :size, :size] = value
    return out


def backdoor_rows(n: int, fraction: float, gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """The backdoor's random choice: ``int(n * fraction)`` distinct rows."""
    k = int(n * float(fraction))
    return torch.randperm(n, generator=gen)[:k]


def poison_backdoor(
    x: torch.Tensor,
    y: torch.Tensor,
    target_class: int,
    fraction: float,
    idx: Optional[torch.Tensor] = None,
    gen: Optional[torch.Generator] = None,
    size: int = 5,
    value: float = 2.8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stamp the trigger on a ``fraction`` of a client's samples (the rows
    ``idx``, drawn by ``backdoor_rows`` from ``gen`` when absent) and relabel
    them to ``target_class``."""
    if int(x.shape[0] * float(fraction)) == 0:
        return x, y
    if idx is None:
        idx = backdoor_rows(x.shape[0], fraction, gen)
    idx = torch.as_tensor(idx, dtype=torch.long)
    x, y = x.clone(), y.clone()
    x[idx] = add_backdoor_pattern(x[idx], size=size, value=value)
    y[idx] = target_class
    return x, y


def alie_attack(updates: Updates, byzantine_idxs: Sequence[int], num_std: float,
                mode: str = "craft") -> Updates:
    """'A little is enough' (Baruch et al.): keep malicious updates inside the
    benign per-coordinate range [mean - z*std, mean + z*std].  ``craft``
    places every malicious update at mean - z*std; ``clip`` clips each
    malicious client's own update into the range."""
    bad = set(int(i) for i in byzantine_idxs)
    benign = [p for j, (_, p) in enumerate(updates) if j not in bad]
    if not benign:
        return updates
    layout = FlatLayout.of(benign[0])
    vecs = torch.stack([layout.ravel(p) for p in benign], 0)
    mean = torch.mean(vecs, dim=0)
    std = torch.std(vecs, dim=0, correction=0)
    z = float(num_std)
    lo, hi = mean - z * std, mean + z * std
    if mode == "craft":
        mal = layout.unravel(lo, benign[0])
        return [(n, mal if j in bad else p) for j, (n, p) in enumerate(updates)]
    if mode == "clip":
        out = list(updates)
        for j in bad:
            n, p = updates[j]
            clipped = torch.minimum(torch.maximum(layout.ravel(p), lo), hi)
            out[j] = (n, layout.unravel(clipped, p))
        return out
    raise ValueError(f"unknown alie mode {mode!r}")


# ---------------------------------------------------------------------------
# Edge-case backdoor (Wang et al. 2020)
# ---------------------------------------------------------------------------
def select_edge_cases(logits: torch.Tensor, fraction: float) -> torch.Tensor:
    """Indices of the tail samples, lowest max-softmax confidence first
    (fraction 0 selects none)."""
    conf = torch.max(torch.softmax(logits.float(), dim=-1), dim=-1).values
    k = int(conf.shape[0] * float(fraction))
    return torch.argsort(conf, stable=True)[:k]


def poison_edge_cases(x: torch.Tensor, y: torch.Tensor, logits: torch.Tensor,
                      target_class: int, fraction: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relabel the edge-case tail to ``target_class`` (no visible trigger)."""
    idx = select_edge_cases(logits, fraction)
    y = y.clone()
    y[idx] = target_class
    return x, y


def edge_case_choice(pool_n: int, n: int, k: int,
                     gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The edge-case pool's random choice: ``k`` pool rows (with
    replacement) and ``k`` distinct client rows to overwrite."""
    src = torch.randint(pool_n, (k,), generator=gen)
    pos = torch.randperm(n, generator=gen)[:k]
    return src, pos


def inject_edge_cases(x: torch.Tensor, y: torch.Tensor, pool: torch.Tensor, target_class: int,
                      src: torch.Tensor, pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Overwrite client rows ``pos`` with pool rows ``src``, labeled target."""
    x, y = x.clone(), y.clone()
    x[pos] = pool[src].to(x.dtype)
    y[pos] = target_class
    return x, y


def project_to_norm_ball(params: Tree, global_params: Tree, eps: float) -> Tree:
    """Project a (malicious) model onto the eps-ball around the global model."""
    layout = FlatLayout.of(global_params)
    g_vec = layout.ravel(global_params)
    d_vec = layout.ravel(params) - g_vec
    norm = torch.linalg.vector_norm(d_vec)
    scale = torch.clamp_max(eps / torch.clamp_min(norm, 1e-12), 1.0)
    return layout.unravel(g_vec + d_vec * scale, params)
