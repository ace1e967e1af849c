"""Attack simulations over client updates and client data (counterpart of
``fedml_tpu/core/security/attack_funcs.py``).

* byzantine (zero / random / flip modes);
* label flipping (poison a dataset's labels);
* model replacement (the scaled malicious push);
* backdoor: trigger-pattern data poisoning and ALIE in-range evasion;
* edge-case backdoor: tail-sample relabeling and the norm-ball projection;
* the analysis attacks on one intercepted update: DLG (L2 gradient
  matching), inverting gradients (cosine matching and a total-variation
  prior) and revealing labels from the head bias's gradient.

Updates are ``(sample_num, {name: tensor})`` pairs; data are tensors, images
NHWC.  The random choices (byzantine ``random``'s garbage, the backdoor's
rows, the reconstruction's starting point) are arguments with a
generator-drawn default, so a test can pass the JAX package's.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...models.convert import FlatLayout, is_batch_stat, module_state

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


# ---------------------------------------------------------------------------
# Gradient inversion (DLG): reconstruct a batch by matching gradients
# ---------------------------------------------------------------------------
# grad_fn(x, y_soft) -> the victim's parameter gradients, each with its graph
GradFn = Callable[[torch.Tensor, torch.Tensor], Sequence[torch.Tensor]]


def _ravel(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


@contextlib.contextmanager
def _eval_mode(module: torch.nn.Module):
    """The module in eval mode (flax's ``train=False``) inside the block."""
    was = module.training
    module.eval()
    try:
        yield module
    finally:
        module.train(was)


def victim_grad_fn(module: torch.nn.Module, variables: Tree) -> GradFn:
    """``grad_fn(x, y_soft)``: the gradient of the mean soft-label
    cross-entropy (fp32 logits) of ``module`` at ``variables`` in each
    parameter, in ``module.named_parameters()`` order, with its graph kept
    (``create_graph``), so a loss of the gradients differentiates in x and
    y.  The module runs in eval mode through ``functional_call``, its
    BatchNorm normalising with the running averages of ``variables`` (flax's
    ``train=False``); its own parameters and buffers are not touched."""
    names = [n for n, _ in module.named_parameters()]
    buffers = {n: variables[n] for n, _ in module_state(module) if is_batch_stat(n)}

    def grad_fn(x: torch.Tensor, y_soft: torch.Tensor) -> Sequence[torch.Tensor]:
        params = {n: variables[n].detach().requires_grad_() for n in names}
        with _eval_mode(module):
            logits = torch.func.functional_call(module, {**params, **buffers}, (x,)).float()
        loss = -(y_soft * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()
        return torch.autograd.grad(loss, [params[n] for n in names], create_graph=True)

    return grad_fn


def target_grads(module: torch.nn.Module, variables: Tree, client_update: Tree,
                 lr_client: float) -> List[torch.Tensor]:
    """The intercepted step's gradient estimate (w_prev - w_new) / lr, in
    ``module.named_parameters()`` order."""
    return [(variables[n] - client_update[n]) / lr_client for n, _ in module.named_parameters()]


def match_loss(grad_fn: GradFn, target: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               match: str = "l2", tv_weight: float = 0.0) -> torch.Tensor:
    """The gradient-match loss of the dummy ``(x, y logits)`` against the
    raveled ``target``: ``"l2"`` the squared distance (DLG, Zhu et al.),
    ``"cosine"`` one minus the cosine similarity (Inverting Gradients,
    Geiping et al.); ``tv_weight`` > 0 adds a total-variation prior on 4-D
    (NHWC) inputs."""
    g = _ravel(grad_fn(x, torch.softmax(y, dim=-1)))
    if match == "cosine":
        out = 1.0 - torch.dot(g, target) / torch.clamp_min(
            torch.linalg.vector_norm(g) * torch.linalg.vector_norm(target), 1e-12)
    else:
        out = torch.sum((g - target) ** 2)
    if tv_weight > 0 and x.dim() == 4:  # NHWC image prior
        out = out + tv_weight * ((x[:, 1:, :, :] - x[:, :-1, :, :]).abs().mean()
                                 + (x[:, :, 1:, :] - x[:, :, :-1, :]).abs().mean())
    return out


def invert_gradient(grad_fn: GradFn, target: Sequence[torch.Tensor], x_shape: Tuple[int, ...],
                    y_logits_shape: Tuple[int, ...], gen: Optional[torch.Generator] = None,
                    steps: int = 100, lr: float = 0.1, match: str = "l2",
                    tv_weight: float = 0.0,
                    init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reconstruct a dummy ``(x, y logits)`` whose gradients match ``target``
    (a list of parameter gradients): plain gradient descent from ``init``
    (when absent, x then y drawn standard normal on the CPU from ``gen``, a
    CPU generator) with the step ``lr * (0.5 + 0.5 cos(pi i / steps))``, on
    ``match_loss``, on the target's device.  Both analysis attacks delegate
    here."""
    tvec = _ravel(target).detach()
    if init is None:
        init = (torch.randn(x_shape, generator=gen), torch.randn(y_logits_shape, generator=gen))
    x, y = (t.to(device=tvec.device, dtype=torch.float32) for t in init)
    with torch.enable_grad():
        for i in range(int(steps)):
            x, y = x.detach().requires_grad_(), y.detach().requires_grad_()
            gx, gy = torch.autograd.grad(match_loss(grad_fn, tvec, x, y, match, tv_weight),
                                         (x, y))
            step = lr * (0.5 + 0.5 * math.cos(math.pi * i / steps))
            x, y = x.detach() - step * gx, y.detach() - step * gy
    return x, y


def update_match_loss(module: torch.nn.Module, variables: Tree, client_update: Tree,
                      x: torch.Tensor, y: torch.Tensor, lr_client: float = 0.1,
                      match: str = "l2", tv_weight: float = 0.0) -> float:
    """The matching loss the attacks minimise, at ``(x, y logits)``, for the
    update ``variables -> client_update``."""
    tvec = _ravel(target_grads(module, variables, client_update, lr_client)).detach()
    with torch.enable_grad():
        return float(match_loss(victim_grad_fn(module, variables), tvec, x, y, match,
                                tv_weight).detach())


def invert_gradient_attack(module: torch.nn.Module, variables: Tree, client_update: Tree,
                           x_shape: Tuple[int, ...], num_classes: int,
                           gen: Optional[torch.Generator] = None, lr_client: float = 0.1,
                           steps: int = 200, lr_attack: float = 0.1, tv_weight: float = 1e-2,
                           init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """'Inverting Gradients' (Geiping et al.) from an intercepted update:
    cosine gradient matching and a total-variation image prior.  Returns
    ``(x_rec, y_soft_logits)``."""
    return invert_gradient(victim_grad_fn(module, variables),
                           target_grads(module, variables, client_update, lr_client),
                           x_shape, (x_shape[0], num_classes), gen, steps=steps, lr=lr_attack,
                           match="cosine", tv_weight=tv_weight, init=init)


def dlg_attack(module: torch.nn.Module, variables: Tree, client_update: Tree,
               x_shape: Tuple[int, ...], num_classes: int,
               gen: Optional[torch.Generator] = None, lr_client: float = 0.1,
               steps: int = 200, lr_attack: float = 0.1,
               init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Deep leakage from gradients: take the client's step gradient as
    (w_global - w_client) / lr and reconstruct a representative ``(x, y)`` by
    L2 gradient matching.  Returns ``(x_rec, y_soft_logits)``."""
    return invert_gradient(victim_grad_fn(module, variables),
                           target_grads(module, variables, client_update, lr_client),
                           x_shape, (x_shape[0], num_classes), gen, steps=steps, lr=lr_attack,
                           init=init)


# ---------------------------------------------------------------------------
# Revealing labels from gradients (sign heuristic)
# ---------------------------------------------------------------------------
def reveal_labels_from_gradients(last_layer_bias_grad: torch.Tensor) -> torch.Tensor:
    """Classes present in a cross-entropy batch have negative bias-gradient
    entries (the iDLG observation): class indices, most negative first."""
    return torch.argsort(last_layer_bias_grad, stable=True)


def reveal_labels_from_update(variables: Tree, client_update: Tree, num_classes: int,
                              lr_client: float = 0.1, head_path=None,
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Label revelation from an intercepted update: the classifier bias's
    gradient estimate (w_prev - w_new) / lr, and ``(order, present)``, class
    indices most likely present first and the negative-entry mask.

    ``head_path`` names the head's bias by its flax path, a key tuple such as
    ``("Dense_2", "bias")`` or the string ``"Dense_2/bias"``.  Without it the
    JAX package's fallback picks the leaf: among the ``(num_classes,)``
    leaves in flax's flatten order (keys sorted at every level, so
    ``Dense_10`` comes before ``Dense_2``), those whose path names a bias
    when there are any, and of them the last.  From ten layers on that is
    not the output layer, as in the JAX package: pass ``head_path`` there."""
    layout = FlatLayout.of(variables)
    if head_path is not None:
        keys = tuple(head_path.split("/")) if isinstance(head_path, str) else tuple(head_path)
        try:
            name, _, _, fshape, _, _ = layout.entry(keys)
        except KeyError:
            raise ValueError(f"head_path {head_path!r} not found in the params tree") from None
        if fshape != (num_classes,):
            raise ValueError(
                f"head_path {head_path!r} leaf has shape {fshape}, expected ({num_classes},) "
                "— it must name the classifier-head BIAS")
    else:
        candidates = [("bias" in "/".join(path).lower(), name)
                      for name, path, _, fshape, _, _ in layout.entries
                      if fshape == (num_classes,)]
        if not candidates:
            raise ValueError(f"no ({num_classes},) bias leaf in the params tree — cannot "
                             "locate the classifier head for label revelation")
        has_bias = any(is_bias for is_bias, _ in candidates)
        name = [n for is_bias, n in candidates if is_bias or not has_bias][-1]
    bias_grad = (variables[name].float() - client_update[name].float()) / lr_client
    return reveal_labels_from_gradients(bias_grad), bias_grad < 0
