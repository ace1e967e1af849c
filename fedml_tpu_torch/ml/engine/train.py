"""Local-training engine of the port: counterpart of
``fedml_tpu/ml/engine/train.py``.

Model state is a *variables* dict, parameter name -> tensor, loaded into one
``nn.Module`` that every client of a round reuses.  Local training runs
eagerly: per epoch a shuffle, per step a masked batch, loss, backward and an
optimizer step.  Semantics follow the JAX engine:

* data are valid-first and padded to ``padded_n`` rows; rows at or past
  ``n_valid`` are masked out of the loss;
* a batch that is all padding takes no optimizer step at all, so the
  parameters AND the optimizer state are left as they were (the JAX engine's
  ``jnp.where(any_valid, ...)``);
* the loss is a masked mean over tokens, and the run's loss the mean of the
  step losses weighted by each batch's valid examples;
* a grad hook (FedProx, SCAFFOLD, FedDyn: ``resolve_grad_hook``) rewrites
  each step's gradients after ``backward()`` and before the optimizer step,
  where the JAX engine calls it between ``value_and_grad`` and
  ``tx.update``; torch's coupled weight decay is then added inside the step,
  as optax's ``add_decayed_weights`` is after the hook.

The shuffle uses a ``torch.Generator`` seeded from (seed..., epoch); its
permutations are not ``jax.random``'s, so tests compare the two engines
where the shuffle cannot matter (one full batch per epoch).  Dropout masks
(``models/cnn.py``'s ``Dropout``) come from one generator a client run,
seeded from (seed..., ``DROPOUT_SALT``) on the data's device; they cannot be
the JAX engine's either, so parity tests hold dropout models with dropout
made deterministic on both sides.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.rng import seeded_generator

Variables = Dict[str, torch.Tensor]
Tensors = List[torch.Tensor]
# hook(grads, params, anchor, extra): rewrites ``grads`` in place.  Every list
# is in ``module.named_parameters()`` order; ``anchor`` holds the round-start
# params and ``extra`` the client's ``engine_extra`` laid out the same way
# (or None).  It runs under ``torch.no_grad()``.
GradHook = Callable[[Tensors, Tensors, Tensors, Optional[Tensors]], None]
# post_train(variables, gen) -> variables: a client's final variables before
# they leave it (local DP noise), drawn from ``gen``
PostTrain = Callable[[Variables, torch.Generator], Variables]
# the salt of a client's post-train generator, the JAX package's
# fold_in(rng, 104729)
POST_TRAIN_SALT = 104729
# the salt of a client run's dropout masks (the JAX engine folds each step's
# dropout key out of the run's key instead)
DROPOUT_SALT = 2718


def post_train_generator(seed: Sequence[int], device) -> torch.Generator:
    """The generator of a client's ``post_train``: (seed, round, client,
    104729) on the device of its variables."""
    return seeded_generator((*seed, POST_TRAIN_SALT), device)


class LocalTrainResult(NamedTuple):
    variables: Variables
    loss: torch.Tensor  # mean masked loss over the run (0-d, on the device)
    seen: float  # number of valid samples processed
    steps: float = 0.0  # optimizer steps taken
    opt_state: Optional[dict] = None  # the client optimizer's final state


def make_optimizer(args) -> Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer]:
    """Client optimizer factory: params -> optimizer, one per client run.

    The optax chains of the JAX engine, step for step: ``sgd`` (with
    ``momentum`` > 0 the trace g + m*t), ``adam`` (b1 0.9, b2 0.999, eps
    1e-8) and ``adamw`` (decoupled decay).  ``weight_decay`` > 0 ahead of sgd
    or adam is optax's ``add_decayed_weights`` (g + wd*p), which is what torch's
    coupled ``weight_decay`` computes."""
    name = str(getattr(args, "client_optimizer", "sgd")).lower()
    lr = float(getattr(args, "learning_rate", 0.01))
    wd = float(getattr(args, "weight_decay", 0.0))
    momentum = float(getattr(args, "momentum", 0.0))
    if name == "sgd":
        return lambda params: torch.optim.SGD(params, lr=lr, momentum=max(momentum, 0.0),
                                              weight_decay=wd)
    if name == "adam":
        return lambda params: torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                               weight_decay=wd)
    if name == "adamw":
        return lambda params: torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                                weight_decay=wd)
    raise ValueError(f"unknown client_optimizer {name!r}")


def resolve_grad_hook(args, grad_hook: Optional[GradHook]) -> Optional[GradHook]:
    """Shared grad-hook resolution for both engines: an explicit hook wins;
    otherwise ``args.proximal_mu`` > 0 installs FedProx's ``g + mu*(p -
    anchor)``."""
    mu = float(getattr(args, "proximal_mu", 0.0) or 0.0)
    if grad_hook is None and mu > 0:
        def grad_hook(grads, params, anchor, extra):
            # g + mu*p - mu*a: in place, where p - a would allocate a tensor
            # a param every step
            torch._foreach_add_(grads, params, alpha=mu)
            torch._foreach_add_(grads, anchor, alpha=-mu)
    return grad_hook


def param_list(tree: Optional[Variables], names: Sequence[str]) -> Optional[Tensors]:
    """A ``{name: tensor}`` dict as a list in ``names``' order (None stays None)."""
    return None if tree is None else [tree[n] for n in names]


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position CE in fp32 over the last axis of ``logits``: labels
    ``logits.shape[:-1]``, every one in range."""
    v = logits.shape[-1]
    return F.cross_entropy(logits.float().reshape(-1, v), labels.reshape(-1).long(),
                           reduction="none").reshape(labels.shape)


def _masked_mean(per: torch.Tensor, mask: torch.Tensor):
    """(mean, (total, count)) of ``per`` under a mask that broadcasts over
    its trailing axes; the count is at least 1."""
    mask = mask.float().reshape(mask.shape + (1,) * (per.dim() - mask.dim()))
    total = (per * mask).sum()
    count = mask.expand(per.shape).sum().clamp_min(1.0)
    return total / count, (total, count)


def softmax_ce_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """Masked CE.  Handles [B] labels, [B, L] per-token labels (NWP) and
    [B, H, W] per-pixel labels (segmentation): a per-example mask [B]
    broadcasts over the trailing label axes.  Logits are promoted to fp32.
    Returns (mean, (total, count))."""
    return _masked_mean(_ce(logits, labels), mask)


def sigmoid_bce_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """Masked multi-label BCE: labels are multi-hot [B, C] floats (tag
    prediction); the per-example mask [B] broadcasts over label positions."""
    per = F.binary_cross_entropy_with_logits(logits.float(), labels.float(), reduction="none")
    return _masked_mean(per, mask)


def span_ce_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """Span extraction: logits [B, L, 2], labels [B, 2] = (start, end); CE
    over sequence positions for each endpoint, summed."""
    per = _ce(logits[..., 0], labels[:, 0]) + _ce(logits[..., 1], labels[:, 1])
    return _masked_mean(per, mask)


def detection_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                   box_weight: float = 5.0):
    """Single-object detection: logits [B, C+4] (class logits, then the box),
    labels [B, 5] = (class, cx, cy, w, h); the class CE plus ``box_weight``
    times the smooth-L1 (beta 1) of the box summed over its four
    coordinates, masked per example."""
    n_cls = logits.shape[-1] - 4
    logits = logits.float()
    per_cls = _ce(logits[:, :n_cls], labels[:, 0].long())
    diff = (logits[:, n_cls:] - labels[:, 1:].float()).abs()
    per_box = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(dim=-1)
    return _masked_mean(per_cls + box_weight * per_box, mask)


def seq2seq_ce_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """Seq2seq teacher-forced CE over a causal LM's [B, L, V] logits; labels
    [B, L] with -1 on the positions that carry no target (the source
    prefix).  The -1 labels are clamped to 0 for the CE and masked out after
    it, as in the JAX package, so the count is the target positions under
    the example mask."""
    per = _ce(logits, labels.clamp_min(0))
    mask = mask.float().reshape(mask.shape + (1,) * (per.dim() - mask.dim()))
    return _masked_mean(per, (labels >= 0).float() * mask)


def masked_sentinel_bce_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """BCE over the labeled entries only, -1 marking an unlabeled one: link
    prediction ([B, N, N] pairwise scores; labeled are the held-out positives
    and the sampled negatives) and multi-task property prediction with
    partial labels ([B, T] task logits, the SpreadGNN setting).  The -1
    labels are clamped to 0 for the BCE and masked out after it; the count
    is the labeled entries under the example mask."""
    per = F.binary_cross_entropy_with_logits(logits.float(), labels.float().clamp_min(0.0),
                                             reduction="none")
    mask = mask.float().reshape(mask.shape + (1,) * (per.dim() - mask.dim()))
    return _masked_mean(per, (labels >= 0).float() * mask)


def mse_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """Masked mean-squared error: each example's mean over its trailing axes
    of (prediction - target)², the targets shaped as the predictions (graph
    property regression)."""
    sq = torch.square(logits.float() - labels.float())
    per = sq.mean(dim=tuple(range(1, sq.dim()))) if sq.dim() > 1 else sq
    return _masked_mean(per, mask)


LOSS_FNS = {"ce": softmax_ce_loss, "bce": sigmoid_bce_loss, "span": span_ce_loss,
            "det": detection_loss, "s2s": seq2seq_ce_loss,
            "linkpred": masked_sentinel_bce_loss, "mtl_bce": masked_sentinel_bce_loss,
            "mse": mse_loss}


def build_loss_fn(module: nn.Module, loss: str = "ce") -> Callable:
    """(bx, by, bmask) -> scalar masked loss of ``module`` on the batch."""
    if loss not in LOSS_FNS:
        raise NotImplementedError(
            f"loss {loss!r} is not ported yet (ROADMAP.md queue A, item 4: model zoo and "
            "trainers, the losses)")
    loss_kind = LOSS_FNS[loss]

    def loss_fn(bx, by, bmask):
        return loss_kind(module(bx), by, bmask)[0]

    return loss_fn


def load_variables(module: nn.Module, variables: Variables) -> None:
    """Copy a variables dict into the module's parameters, in place."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(variables[name])


def get_variables(module: nn.Module) -> Variables:
    return {name: p.detach().clone() for name, p in module.named_parameters()}


def seed_dropout(module: nn.Module, seed: Sequence[int], device) -> None:
    """Point every ``Dropout`` of ``module`` at one generator on ``device``
    seeded from (``seed``..., ``DROPOUT_SALT``): a run draws its masks in
    call order, so a replay draws the same ones."""
    from ...models.cnn import Dropout

    layers = [m for m in module.modules() if isinstance(m, Dropout)]
    if layers:
        gen = seeded_generator((*seed, DROPOUT_SALT), device)
        for m in layers:
            m.generator = gen


def shuffle_generator(seed: Sequence[int]) -> torch.Generator:
    """A CPU generator seeded from a tuple of ints (e.g. run seed, round,
    client, epoch) through numpy's SeedSequence."""
    return seeded_generator(seed)


def build_local_train(
    module: nn.Module,
    args,
    batch_size: int,
    padded_n: int,
    epochs: Optional[int] = None,
    loss: str = "ce",
    grad_hook: Optional[GradHook] = None,
    post_train: Optional[PostTrain] = None,
) -> Callable[..., LocalTrainResult]:
    """Returned fn: ``(variables, x [padded_n, ...], y [padded_n, ...],
    n_valid, seed, extra=None) -> LocalTrainResult``.  ``x``/``y`` lie on the
    module's device; ``seed`` is a tuple of ints that fixes the shuffles;
    ``extra`` is the client's ``{name: tensor}`` input to the grad hook.
    ``args.proximal_mu`` > 0 installs the FedProx hook when none is given.
    ``post_train`` rewrites the client's final variables after its last step
    (local DP), drawing from ``post_train_generator(seed, device)``."""
    if padded_n < batch_size:
        raise ValueError(f"padded_n ({padded_n}) must be >= batch_size ({batch_size})")
    make_opt = make_optimizer(args)
    epochs = int(epochs if epochs is not None else getattr(args, "epochs", 1))
    steps_per_epoch = max(1, -(-padded_n // batch_size))
    loss_fn = build_loss_fn(module, loss)
    grad_hook = resolve_grad_hook(args, grad_hook)
    names = [name for name, _ in module.named_parameters()]

    def train(variables: Variables, x: torch.Tensor, y: torch.Tensor, n_valid: int,
              seed: Sequence[int] = (0,), extra: Optional[Variables] = None) -> LocalTrainResult:
        load_variables(module, variables)
        module.train()
        seed_dropout(module, seed, x.device)
        params = list(module.parameters())
        anchor, extra_l = param_list(variables, names), param_list(extra, names)
        opt = make_opt(params)
        n_valid = int(n_valid)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        seen = steps = 0.0
        for e in range(epochs):
            perm = torch.randperm(padded_n, generator=shuffle_generator((*seed, e)))
            perm_dev = perm.to(x.device)
            for i in range(steps_per_epoch):
                # the JAX engine's dynamic_slice clamps the last window in range
                start = min(i * batch_size, padded_n - batch_size)
                valid = perm[start:start + batch_size] < n_valid  # host copy: no device sync
                n_b = int(valid.sum())
                if n_b == 0:
                    continue  # all padding: no step, optimizer state untouched
                idx = perm_dev[start:start + batch_size]
                bmask = valid.to(device=x.device, dtype=torch.float32, non_blocking=True)
                step_loss = loss_fn(x.index_select(0, idx), y.index_select(0, idx), bmask)
                opt.zero_grad(set_to_none=True)
                step_loss.backward()
                if grad_hook is not None:
                    with torch.no_grad():
                        grad_hook([p.grad for p in params], params, anchor, extra_l)
                opt.step()
                loss_sum += step_loss.detach() * n_b
                seen += n_b
                steps += 1
        final = get_variables(module)
        if post_train is not None:
            with torch.no_grad():
                final = post_train(final, post_train_generator(seed, x.device))
        return LocalTrainResult(final, loss_sum / max(seen, 1.0), seen, steps,
                                opt.state_dict()["state"])

    return train


def make_eval_fn(module: nn.Module) -> Callable:
    """Masked eval of the module's current parameters: ``(x, y, mask) ->
    (loss_sum, correct, count)`` as 0-d tensors on the device."""

    @torch.no_grad()
    def evaluate(x, y, mask):
        module.eval()
        logits = module(x).float()
        per = _ce(logits, y)
        pred = logits.argmax(dim=-1)
        mask = mask.float().reshape(mask.shape + (1,) * (per.dim() - mask.dim()))
        full = mask.expand(per.shape)
        return (per * full).sum(), ((pred == y).float() * full).sum(), full.sum()

    return evaluate


def pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """Pad dim 0 to length n by repeating the last row (truncate if longer)."""
    if x.shape[0] >= n:
        return x[:n]
    return torch.cat([x, x[-1:].expand((n - x.shape[0],) + tuple(x.shape[1:]))], dim=0)


def init_variables(module: nn.Module, device: torch.device, seed: int = 0) -> Variables:
    """Materialise a module built on the ``meta`` device on ``device`` and fill
    it from a CPU generator seeded with ``seed`` (the same weights on every
    device); returns its variables."""
    if any(p.is_meta for p in module.parameters()):
        module.to_empty(device="cpu")
    module.to("cpu")
    module.init_parameters(torch.Generator().manual_seed(int(seed)))
    module.to(device)
    return get_variables(module)
