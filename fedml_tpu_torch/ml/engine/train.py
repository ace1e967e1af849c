"""Local-training engine of the port: counterpart of
``fedml_tpu/ml/engine/train.py``.

Model state is a *variables* dict, parameter or buffer name -> tensor,
loaded into one ``nn.Module`` that every client of a round reuses.  The
buffers are BatchNorm's running averages (flax's ``batch_stats``): a
training forward moves them, the optimizer never touches them, and they
leave a client with its parameters.  Local training runs eagerly: per epoch
a shuffle, per step a masked batch, loss, backward and an optimizer step.
Semantics follow the JAX engine:

* data are valid-first and padded to ``padded_n`` rows; rows at or past
  ``n_valid`` are masked out of the loss;
* a batch that is all padding takes no step at all, so the parameters, the
  optimizer state AND the BatchNorm buffers are left as they were (the JAX
  engine's ``jnp.where(any_valid, ...)``); any other batch's forward sees
  every row, padding included, so its BatchNorm statistics are the JAX
  engine's, which applies the module to the whole padded batch;
* the loss is a masked mean over tokens, and the run's loss the mean of the
  step losses weighted by each batch's valid examples;
* a grad hook (FedProx, SCAFFOLD, FedDyn: ``resolve_grad_hook``) rewrites
  each step's gradients after ``backward()`` and before the optimizer step,
  where the JAX engine calls it between ``value_and_grad`` and
  ``tx.update``; torch's coupled weight decay is then added inside the step,
  as optax's ``add_decayed_weights`` is after the hook.

``build_chunked_local_train`` is the same run for k clients at once (the
JAX round's ``jax.vmap`` over clients, ``xla_client_chunk``): their variables
stacked ``[k, ...]`` under ``torch.func.vmap``, each client with its own
shuffles, step count, masks and Dropout uniforms.

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

from ...models.convert import module_state
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
    """Copy a variables dict into the module's parameters and buffers, in
    place."""
    with torch.no_grad():
        for name, t in module_state(module):
            t.copy_(variables[name])


def get_variables(module: nn.Module) -> Variables:
    return {name: t.detach().clone() for name, t in module_state(module)}


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


class _StackedOptimizer:
    """``make_optimizer``'s update over stacked ``[k, ...]`` leaves, one
    client a row, with a ``[k]`` step count: a row steps only where its
    client's batch holds a valid row (``live``), as the JAX engine's
    ``jnp.where(any_valid, new, old)`` on params and optimizer state, which
    ``torch.optim``'s one scalar ``step`` cannot do for one client of k.  The
    arithmetic is ``torch.optim``'s single-tensor SGD (momentum, coupled
    weight decay), Adam and AdamW, op for op."""

    def __init__(self, args, params: Tensors):
        self.name = str(getattr(args, "client_optimizer", "sgd")).lower()
        if self.name not in ("sgd", "adam", "adamw"):
            raise ValueError(f"unknown client_optimizer {self.name!r}")
        self.lr = float(getattr(args, "learning_rate", 0.01))
        self.wd = float(getattr(args, "weight_decay", 0.0))
        self.momentum = max(float(getattr(args, "momentum", 0.0)), 0.0)
        k = params[0].shape[0]
        self.steps = [0] * k
        self.slots: Dict[str, Tensors] = {}
        if self.name == "sgd" and self.momentum > 0:
            self.slots["momentum_buffer"] = [torch.zeros_like(p) for p in params]
        elif self.name != "sgd":
            self.slots["exp_avg"] = [torch.zeros_like(p) for p in params]
            self.slots["exp_avg_sq"] = [torch.zeros_like(p) for p in params]

    @staticmethod
    def _rows(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A ``[k]`` tensor as ``[k, 1, ...]``, broadcasting over ``like``'s rows."""
        return t.reshape((-1,) + (1,) * (like.dim() - 1))

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, live: Sequence[bool]) -> None:
        self.steps = [s + int(on) for s, on in zip(self.steps, live)]
        dev = params[0].device
        on = torch.tensor(list(live), device=dev)
        lr, wd, b1, b2, eps = self.lr, self.wd, 0.9, 0.999, 1e-8
        if self.name != "sgd":
            # each client's bias corrections, as torch.optim's python floats
            # (a step of 0 is masked out below); torch rounds such a scalar
            # operand to the parameter's type
            steps = [max(s, 1) for s in self.steps]
            neg_step = torch.tensor([-lr / (1 - b1 ** s) for s in steps], device=dev)
            bc2_sqrt = torch.tensor([(1 - b2 ** s) ** 0.5 for s in steps], device=dev)
        for i, (p, g) in enumerate(zip(params, grads)):
            keep = self._rows(on, p)
            if self.name == "sgd":
                d = g.add(p, alpha=wd) if wd != 0 else g
                if self.momentum > 0:
                    buf = self.slots["momentum_buffer"][i]
                    # a zero buffer times momentum plus d is d exactly:
                    # torch's first-step clone
                    buf.copy_(torch.where(keep, buf.mul(self.momentum).add_(d), buf))
                    d = buf
                p.copy_(torch.where(keep, p.add(d, alpha=-lr), p))
                continue
            if self.name == "adamw":
                new_p = p.mul(1 - lr * wd)
            else:
                new_p = p.clone()
                if wd != 0:
                    g = g.add(p, alpha=wd)
            m, v = self.slots["exp_avg"][i], self.slots["exp_avg_sq"][i]
            m.copy_(torch.where(keep, m.lerp(g, 1 - b1), m))
            v.copy_(torch.where(keep, v.mul(b2).addcmul_(g, g, value=1 - b2), v))
            denom = (v.sqrt() / self._rows(bc2_sqrt.to(p.dtype), p)).add_(eps)
            p.copy_(torch.where(keep, torch.addcdiv(new_p, m * self._rows(
                neg_step.to(p.dtype), p), denom), p))

    def client_state(self, c: int) -> dict:
        """Client ``c``'s state in ``torch.optim``'s ``state_dict()["state"]``
        form (empty when it never stepped, as torch's)."""
        if self.steps[c] == 0 or (self.name == "sgd" and not self.slots):
            return {}
        out = {}
        for i in range(len(next(iter(self.slots.values())))):
            row = {name: t[i][c].clone() for name, t in self.slots.items()}
            if self.name != "sgd":
                row["step"] = torch.tensor(float(self.steps[c]))
            out[i] = row
        return out


def _has_lstm(module: nn.Module) -> bool:
    from ...models.rnn import LSTMCell

    return any(isinstance(m, LSTMCell) for m in module.modules())


def build_chunked_local_train(
    module: nn.Module,
    args,
    batch_size: int,
    padded_n: int,
    epochs: Optional[int] = None,
    loss: str = "ce",
    grad_hook: Optional[GradHook] = None,
    post_train: Optional[PostTrain] = None,
) -> Callable[..., List[LocalTrainResult]]:
    """The padded round's local training of k clients at once, the
    counterpart of the JAX round's ``jax.vmap(one_client)`` over
    ``build_local_train`` (``xla_client_chunk``).

    Returned fn: ``(variables, x [k, padded_n, ...], y [k, padded_n, ...],
    n_valid (k ints), seeds (k tuples), extras (k dicts, or None)) -> k
    LocalTrainResults``, each what :func:`build_local_train` returns for
    that client alone.  The k clients' variables are stacked ``[k, ...]``
    leaves (BatchNorm's running averages as batched buffers); each step's
    forward is ``torch.func.functional_call`` under ``torch.func.vmap``, and
    one ``backward()`` of the summed per-client masked losses gives each
    client its own gradient.  Each client keeps its own shuffles (seed...,
    epoch) and its own step count: a step runs when any client of the chunk
    has a valid row, and a client whose batch is all padding keeps its
    params, optimizer state and running averages (``_StackedOptimizer``,
    ``torch.where``).  Grad hooks see the stacked leaves, the round-start
    anchor broadcast over the k rows.  Dropout masks are drawn from each
    client's own generator outside the vmapped call.  The rnn family is
    refused: torch has no batching rule for ``aten::lstm``."""
    if padded_n < batch_size:
        raise ValueError(f"padded_n ({padded_n}) must be >= batch_size ({batch_size})")
    if _has_lstm(module):
        raise NotImplementedError(
            "the rnn family under xla_client_chunk > 1 is not ported yet: torch has no "
            "batching rule for aten::lstm (ROADMAP.md queue A, item 6c's rest: the rnn "
            "family under xla_client_chunk)")
    if loss not in LOSS_FNS:
        build_loss_fn(module, loss)  # raises, naming the item
    loss_kind = LOSS_FNS[loss]
    epochs = int(epochs if epochs is not None else getattr(args, "epochs", 1))
    steps_per_epoch = max(1, -(-padded_n // batch_size))
    grad_hook = resolve_grad_hook(args, grad_hook)
    state = module_state(module)
    names = [name for name, _ in module.named_parameters()]
    bnames = [name for name, _ in state[len(names):]]
    from ...models.cnn import Dropout

    drops = [m for m in module.modules() if isinstance(m, Dropout) and m.rate > 0.0]
    draw_shapes: Dict[tuple, List[tuple]] = {}  # a batch's shape -> each Dropout's input's

    def client_loss(p, b, us, bx, by, bmask):
        for m, u in zip(drops, us):
            m.chunk_u = u
        try:
            logits = torch.func.functional_call(module, {**p, **b}, (bx,))
        finally:
            for m in drops:
                m.chunk_u = None
        return loss_kind(logits, by, bmask)[0]

    vloss = torch.func.vmap(client_loss)

    def dropout_shapes(p, b, bx) -> List[tuple]:
        """Each Dropout's input shape at a batch of ``bx``'s shape, from one
        client's forward in eval mode (the layers' pre-hooks read it); the
        first probe puts ``drops`` in call order, the order of the draws."""
        key = tuple(bx.shape)
        if key not in draw_shapes:
            seen: Dict[int, tuple] = {}
            hooks = [m.register_forward_pre_hook(
                lambda m, inp: seen.__setitem__(id(m), tuple(inp[0].shape))) for m in drops]
            module.eval()
            try:
                with torch.no_grad():
                    torch.func.functional_call(
                        module, {**{n: t[0] for n, t in p.items()},
                                 **{n: t[0] for n, t in b.items()}}, (bx,))
            finally:
                module.train()
                for h in hooks:
                    h.remove()
            order = list(seen)
            drops.sort(key=lambda m: order.index(id(m)))
            draw_shapes[key] = [seen[id(m)] for m in drops]
        return draw_shapes[key]

    def train(variables: Variables, x: torch.Tensor, y: torch.Tensor,
              n_valid: Sequence[int], seeds: Sequence[Sequence[int]],
              extras: Optional[Sequence[Optional[Variables]]] = None) -> List[LocalTrainResult]:
        k, dev = int(x.shape[0]), x.device
        module.train()
        params = {n: variables[n].detach().unsqueeze(0).repeat(
            (k,) + (1,) * variables[n].dim()).requires_grad_() for n in names}
        buffers = {n: variables[n].detach().unsqueeze(0).repeat(
            (k,) + (1,) * variables[n].dim()) for n in bnames}
        plist = [params[n] for n in names]
        anchor = [variables[n].detach().unsqueeze(0).expand_as(params[n]) for n in names]
        extra_l = None
        if extras is not None and extras[0] is not None:
            extra_l = [torch.stack([e[n] for e in extras]) for n in names]
        opt = _StackedOptimizer(args, plist)
        n_valid_t = torch.tensor([int(n) for n in n_valid])
        gens = [seeded_generator((*s, DROPOUT_SALT), dev) for s in seeds] if drops else []
        x_flat = x.reshape((k * padded_n,) + tuple(x.shape[2:]))
        y_flat = y.reshape((k * padded_n,) + tuple(y.shape[2:]))
        offsets = torch.arange(k)[:, None] * padded_n
        loss_sum = torch.zeros((k,), dtype=torch.float32, device=dev)
        seen = torch.zeros((k,), dtype=torch.float64)
        for e in range(epochs):
            perms = torch.stack([torch.randperm(padded_n, generator=shuffle_generator((*s, e)))
                                 for s in seeds])
            for i in range(steps_per_epoch):
                # the JAX engine's dynamic_slice clamps the last window in range
                start = min(i * batch_size, padded_n - batch_size)
                idx = perms[:, start:start + batch_size]
                valid = idx < n_valid_t[:, None]  # host copy: no device sync
                n_b = valid.sum(dim=1)
                live = (n_b > 0).tolist()
                if not any(live):
                    continue  # all padding for every client: no step at all
                rows = (idx + offsets).reshape(-1).to(dev)
                bx = x_flat.index_select(0, rows).reshape((k, batch_size) + tuple(x.shape[2:]))
                by = y_flat.index_select(0, rows).reshape((k, batch_size) + tuple(y.shape[2:]))
                bmask = valid.to(device=dev, dtype=torch.float32, non_blocking=True)
                us = []
                if drops:
                    for shape in dropout_shapes(params, buffers, bx[0]):
                        us.append(torch.stack([
                            torch.rand(shape, generator=g, device=dev, dtype=torch.float32)
                            if on else torch.zeros(shape, device=dev)
                            for g, on in zip(gens, live)]))
                before = ({n: t.clone() for n, t in buffers.items()}
                          if buffers and not all(live) else None)
                losses = vloss(params, buffers, us, bx, by, bmask)
                for p in plist:
                    p.grad = None
                losses.sum().backward()
                grads = [p.grad for p in plist]
                if grad_hook is not None:
                    with torch.no_grad():
                        grad_hook(grads, plist, anchor, extra_l)
                opt.step(plist, grads, live)
                if before is not None:
                    on = torch.tensor(live, device=dev)
                    for n, t in buffers.items():
                        t.copy_(torch.where(on.reshape((-1,) + (1,) * (t.dim() - 1)), t,
                                            before[n]))
                loss_sum += losses.detach() * n_b.to(device=dev, dtype=torch.float32)
                seen += n_b
        results = []
        for c in range(k):
            final = {n: params[n][c].detach() for n in names}
            final.update({n: buffers[n][c] for n in bnames})
            if post_train is not None:
                with torch.no_grad():
                    final = post_train(final, post_train_generator(seeds[c], dev))
            s_c = float(seen[c])
            results.append(LocalTrainResult(final, loss_sum[c] / max(s_c, 1.0), s_c,
                                            float(opt.steps[c]), opt.client_state(c)))
        return results

    return train


def make_eval_fn(module: nn.Module) -> Callable:
    """Masked eval of the module's current parameters, in eval mode (BatchNorm
    normalises with its running averages, as flax's at ``train=False``):
    ``(x, y, mask) -> (loss_sum, correct, count)`` as 0-d tensors on the
    device."""

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
