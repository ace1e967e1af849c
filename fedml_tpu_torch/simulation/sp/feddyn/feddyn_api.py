"""FedDyn of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/feddyn/feddyn_api.py``): dynamic regularization
(Acar et al.).

Each client keeps a state h_i.  The dataset's trainer is rebuilt with the
grad hook g - h_i + alpha (p - anchor), so the client loss is the task's
(the JAX twin builds the classification trainer for every dataset); after
training h_i <- h_i - alpha (w_i -
w_g), and the server takes the weighted mean minus h/alpha, where h is the
sum of every h_i seen so far over ``client_num_in_total``.  The hook takes
alpha*p - alpha*anchor in place, where the JAX hook takes alpha*(p -
anchor): fp32 roundoff apart (as in the round simulator's FedDyn).  Each
h_i is laid out as its parameter.

The client's training is replaced (no local DP after-hook) and the
aggregate is this rule, not the aggregator's: local DP and on-aggregation
defenses are refused, as the JAX twin skips them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ....core.aggregate import tree_zeros_like, weighted_mean
from ....ml.trainer.trainer_creator import create_model_trainer
from ...xla.algorithms import params_of
from ..fedavg.fedavg_api import LOCAL_DP, ON_DEFENSE, FedAvgAPI


class FedDynAPI(FedAvgAPI):
    SKIPPED_HOOKS = (LOCAL_DP, ON_DEFENSE)

    def __init__(self, args, device, dataset, model):
        super().__init__(args, device, dataset, model)
        self.alpha = float(getattr(args, "feddyn_alpha", 0.01))
        alpha = self.alpha

        def hook(grads, params, anchor, extra):
            # g - h_i + alpha*p - alpha*a, in place
            torch._foreach_sub_(grads, extra)
            torch._foreach_add_(grads, params, alpha=alpha)
            torch._foreach_add_(grads, anchor, alpha=-alpha)

        self.trainer = create_model_trainer(model, args, grad_hook=hook)
        self.client_list = []
        self._setup_clients()
        self.h_clients: Dict[int, Any] = {}
        self.h_mean = tree_zeros_like(params_of(self.w_global))

    def _train_client(self, client, w_global) -> Any:
        cid = client.client_idx
        h_i = self.h_clients.get(cid)
        if h_i is None:
            h_i = tree_zeros_like(params_of(w_global))
        self.trainer.set_model_params(w_global)
        res = self.trainer.train(client.local_training_data, None, self.args, extra=h_i)
        w_i, w_g = params_of(res.variables), params_of(w_global)
        self.h_clients[cid] = {k: h - self.alpha * (w_i[k] - w_g[k]) for k, h in h_i.items()}
        return res.variables

    def server_update(self, w_locals: List[Tuple[float, Any]]) -> Any:
        w_locals = self.aggregator.on_before_aggregation(w_locals)
        avg = weighted_mean(w_locals)
        if self.h_clients:
            n_total = float(self.args.client_num_in_total)
            hs = list(self.h_clients.values())
            # Python's sum, as the JAX package folds: 0 + h_0 + h_1 + ...
            self.h_mean = {k: sum(h[k] for h in hs) / n_total for k in hs[0]}
        new_params = {k: p - self.h_mean[k] / self.alpha for k, p in params_of(avg).items()}
        return self.aggregator.on_after_aggregation(dict(avg, **new_params))
