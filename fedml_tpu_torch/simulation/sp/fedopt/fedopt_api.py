"""FedOpt's server optimizers and the ``sp`` simulator's ``FedOptAPI``
(counterpart of ``fedml_tpu/simulation/sp/fedopt/fedopt_api.py``).

The server treats the weighted-average client delta as a pseudo-gradient and
applies a server optimizer (``server_optimizer`` in sgd/adam/yogi/adagrad,
``server_lr``, ``server_momentum``).  The JAX package takes them from optax;
each is written here as plain tensor functions with optax's contract:

* ``init(params) -> state``;
* ``update(grads, state, params) -> (updates, state)``;
* the updates are ADDED to the params.

``params`` and ``grads`` are ``{name: tensor}`` dicts; the state holds a
step count and ``{name: tensor}`` moments.  The formulas are those of optax
0.2.6 (``optax/_src/transform.py``, ``alias.py``,
``tree_utils/_tree_math.py``):

* ``sgd``: ``optax.sgd(lr, momentum or None)``: the trace ``t = g + m*t``
  (from zeros), update ``-lr * t``; no momentum: ``-lr * g``.
* ``adam``: ``optax.adam(lr, b1=0.9, b2=0.99, eps=1e-3)``: ``mu = (1-b1) g +
  b1 mu``, ``nu = (1-b2) g^2 + b2 nu`` (from zeros), bias-corrected by
  ``1 - b^count`` (computed in float32), update ``-lr * mu_hat /
  (sqrt(nu_hat) + eps)``: eps outside the root.
* ``yogi``: ``optax.yogi(lr, b1=0.9, b2=0.99, eps=1e-3)``: ``mu`` and ``nu``
  start at ``initial_accumulator_value`` 1e-6 (``scale_by_yogi``'s default),
  ``nu = nu - (1-b2) sign(nu - g^2) g^2``, then as adam.
* ``adagrad``: ``optax.adagrad(lr)``: the sum of squares starts at 0.1 and
  takes ``g^2``; update ``-lr * g * rsqrt(s + 1e-7)`` where ``s > 0``, else 0
  (``scale_by_rss`` masks a zero accumulator).

``FedOptAPI`` takes the pseudo-gradient ``w_global - weighted_mean`` of
the (before-stage filtered) updates, applies the server step to the params
and hands the result to the after-aggregation hooks; it aggregates with
``weighted_mean``, not the aggregator, so an on-aggregation defense is
refused (as its JAX twin skips it).

Torch has no Yogi, and its Adagrad starts the accumulator at 0 and adds eps
outside the root, so ``torch.optim`` is not used.  Each update is a few
``torch._foreach_*`` calls over the parameter list.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ....core.aggregate import weighted_mean
from ...xla.algorithms import params_of
from ..fedavg.fedavg_api import ON_DEFENSE, FedAvgAPI

Tensors = Dict[str, torch.Tensor]


class ServerOptimizer(NamedTuple):
    init: Callable[[Tensors], Dict[str, Any]]
    update: Callable[[Tensors, Dict[str, Any], Tensors], Tuple[Tensors, Dict[str, Any]]]


def _full_like(params: Tensors, value: float) -> Tensors:
    return {k: torch.full_like(v, value) for k, v in params.items()}


def _lists(names: List[str], *trees: Tensors) -> List[List[torch.Tensor]]:
    return [[t[k] for k in names] for t in trees]


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.int32(count))


def _sgd(lr: float, momentum: float) -> ServerOptimizer:
    def init(params):
        return {"trace": _full_like(params, 0.0)} if momentum > 0 else {}

    def update(grads, state, params=None):
        names = list(grads)
        (g,) = _lists(names, grads)
        if momentum > 0:
            (t,) = _lists(names, state["trace"])
            t = torch._foreach_add(g, torch._foreach_mul(t, momentum))
            state = {"trace": dict(zip(names, t))}
            g = t
        return dict(zip(names, torch._foreach_mul(g, -lr))), state

    return ServerOptimizer(init, update)


def _adaptive(lr: float, b1: float, b2: float, eps: float, init_value: float,
              yogi: bool) -> ServerOptimizer:
    def init(params):
        return {"count": 0, "mu": _full_like(params, init_value),
                "nu": _full_like(params, init_value)}

    def update(grads, state, params=None):
        names = list(grads)
        g, mu, nu = _lists(names, grads, state["mu"], state["nu"])
        g2 = torch._foreach_mul(g, g)
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - b1), torch._foreach_mul(mu, b1))
        if yogi:
            sign = torch._foreach_sign(torch._foreach_sub(nu, g2))
            nu = torch._foreach_sub(nu, torch._foreach_mul(torch._foreach_mul(sign, 1.0 - b2),
                                                           g2))
        else:
            nu = torch._foreach_add(torch._foreach_mul(g2, 1.0 - b2), torch._foreach_mul(nu, b2))
        count = int(state["count"]) + 1
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
        nu_hat = torch._foreach_div(nu, _bias_correction(b2, count))
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
        upd = torch._foreach_mul(torch._foreach_div(mu_hat, denom), -lr)
        return dict(zip(names, upd)), {"count": count, "mu": dict(zip(names, mu)),
                                       "nu": dict(zip(names, nu))}

    return ServerOptimizer(init, update)


def _adagrad(lr: float, init_value: float = 0.1, eps: float = 1e-7) -> ServerOptimizer:
    def init(params):
        return {"sum_of_squares": _full_like(params, init_value)}

    def update(grads, state, params=None):
        names = list(grads)
        g, s = _lists(names, grads, state["sum_of_squares"])
        s = torch._foreach_add(torch._foreach_mul(g, g), s)
        inv = [torch.where(t > 0, torch.rsqrt(t + eps), torch.zeros_like(t)) for t in s]
        upd = torch._foreach_mul(torch._foreach_mul(inv, g), -lr)
        return dict(zip(names, upd)), {"sum_of_squares": dict(zip(names, s))}

    return ServerOptimizer(init, update)


def make_server_optimizer(args) -> ServerOptimizer:
    name = str(getattr(args, "server_optimizer", "adam")).lower()
    lr = float(getattr(args, "server_lr", 1e-1))
    momentum = float(getattr(args, "server_momentum", 0.9))
    if name == "sgd":
        return _sgd(lr, momentum)
    if name == "adam":
        return _adaptive(lr, 0.9, 0.99, 1e-3, 0.0, yogi=False)
    if name == "yogi":
        return _adaptive(lr, 0.9, 0.99, 1e-3, 1e-6, yogi=True)
    if name == "adagrad":
        return _adagrad(lr)
    raise ValueError(f"unknown server_optimizer {name!r}")


class FedOptAPI(FedAvgAPI):
    SKIPPED_HOOKS = (ON_DEFENSE,)

    def __init__(self, args, device, dataset, model):
        super().__init__(args, device, dataset, model)
        self._server_tx = make_server_optimizer(args)
        self._server_opt_state = self._server_tx.init(params_of(self.w_global))

    def server_update(self, w_locals: List[Tuple[float, Any]]) -> Any:
        w_locals = self.aggregator.on_before_aggregation(w_locals)
        avg = weighted_mean(w_locals)
        params = params_of(self.w_global)
        pseudo_grad = {k: p - avg[k] for k, p in params.items()}
        updates, self._server_opt_state = self._server_tx.update(
            pseudo_grad, self._server_opt_state, params)
        new_params = {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
        return self.aggregator.on_after_aggregation(dict(avg, **new_params))
