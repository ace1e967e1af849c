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
  step losses weighted by each batch's valid examples.

The shuffle uses a ``torch.Generator`` seeded from (seed..., epoch); its
permutations are not ``jax.random``'s, so tests compare the two engines
where the shuffle cannot matter (one full batch per epoch).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Variables = Dict[str, torch.Tensor]


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


def softmax_ce_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """Masked CE.  Handles both [B] labels and [B, L] per-token labels (NWP):
    a per-example mask [B] broadcasts over trailing label axes.  Logits are
    promoted to fp32.  Returns (mean, (total, count))."""
    v = logits.shape[-1]
    per = F.cross_entropy(logits.float().reshape(-1, v), labels.reshape(-1).long(),
                          reduction="none").reshape(labels.shape)
    mask = mask.float().reshape(mask.shape + (1,) * (per.dim() - mask.dim()))
    total = (per * mask).sum()
    count = mask.expand(per.shape).sum().clamp_min(1.0)
    return total / count, (total, count)


LOSS_FNS = {"ce": softmax_ce_loss}


def build_loss_fn(module: nn.Module, loss: str = "ce") -> Callable:
    """(bx, by, bmask) -> scalar masked loss of ``module`` on the batch."""
    if loss not in LOSS_FNS:
        raise NotImplementedError(
            f"loss {loss!r} is not ported yet (ROADMAP.md queue A, item 14)")
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


def shuffle_generator(seed: Sequence[int]) -> torch.Generator:
    """A CPU generator seeded from a tuple of ints (e.g. run seed, round,
    client, epoch) through numpy's SeedSequence."""
    state = np.random.SeedSequence([int(s) for s in seed]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def build_local_train(
    module: nn.Module,
    args,
    batch_size: int,
    padded_n: int,
    epochs: Optional[int] = None,
    loss: str = "ce",
) -> Callable[..., LocalTrainResult]:
    """Returned fn: ``(variables, x [padded_n, ...], y [padded_n, ...],
    n_valid, seed) -> LocalTrainResult``.  ``x``/``y`` lie on the module's
    device; ``seed`` is a tuple of ints that fixes the shuffles."""
    if padded_n < batch_size:
        raise ValueError(f"padded_n ({padded_n}) must be >= batch_size ({batch_size})")
    make_opt = make_optimizer(args)
    epochs = int(epochs if epochs is not None else getattr(args, "epochs", 1))
    steps_per_epoch = max(1, -(-padded_n // batch_size))
    loss_fn = build_loss_fn(module, loss)

    def train(variables: Variables, x: torch.Tensor, y: torch.Tensor, n_valid: int,
              seed: Sequence[int] = (0,)) -> LocalTrainResult:
        load_variables(module, variables)
        module.train()
        opt = make_opt(list(module.parameters()))
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
                opt.step()
                loss_sum += step_loss.detach() * n_b
                seen += n_b
                steps += 1
        return LocalTrainResult(get_variables(module), loss_sum / max(seen, 1.0), seen, steps,
                                opt.state_dict()["state"])

    return train


def make_eval_fn(module: nn.Module) -> Callable:
    """Masked eval of the module's current parameters: ``(x, y, mask) ->
    (loss_sum, correct, count)`` as 0-d tensors on the device."""

    @torch.no_grad()
    def evaluate(x, y, mask):
        module.eval()
        logits = module(x).float()
        per = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long(),
                              reduction="none").reshape(y.shape)
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
