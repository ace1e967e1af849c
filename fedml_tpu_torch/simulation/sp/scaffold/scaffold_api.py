"""SCAFFOLD of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/scaffold/scaffold_api.py``): stochastic controlled
averaging (Karimireddy et al.).

Each client keeps a control variate c_i and the server a control c.  The
dataset's trainer is rebuilt with the grad hook g - c_i + c, so the client
loss is the task's (the JAX twin builds the classification trainer for
every dataset, whose CE reads a seq2seq label -1 as the last token); after
K local steps (the
trainer's recorded steps) c_i+ = c_i - c + (w_g - w_i) / (K * lr), and after
the FedAvg server step c <- c + (1/N) sum_i (c_i+ - c_i), N the
population.  The hook adds c - c_i, folded once a client, where the JAX
hook takes (g - c_i) + c: the two differ by fp32 roundoff (as in the round
simulator's SCAFFOLD).  Each c_i and c is laid out as its parameter
(``zeros_like``), so the hook's foreach add takes its fused path on the
card.

The client's training is replaced, so the trainer's after-hook (local DP)
does not run: local DP is refused, as the JAX twin skips it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ....core.aggregate import tree_sub, tree_sum, tree_zeros_like
from ....ml.trainer.trainer_creator import create_model_trainer
from ...xla.algorithms import params_of
from ..fedavg.fedavg_api import LOCAL_DP, FedAvgAPI


def _scaffold_hook(grads, params, anchor, extra):
    torch._foreach_add_(grads, extra)  # extra = c - c_i


class ScaffoldAPI(FedAvgAPI):
    SKIPPED_HOOKS = (LOCAL_DP,)

    def __init__(self, args, device, dataset, model):
        super().__init__(args, device, dataset, model)
        # a grad-hooked trainer, and the client slots bound to it
        self.trainer = create_model_trainer(model, args, grad_hook=_scaffold_hook)
        self.client_list = []
        self._setup_clients()
        self.lr = float(getattr(args, "learning_rate", 0.01))
        self.c_server = tree_zeros_like(params_of(self.w_global))
        self.c_clients: Dict[int, Any] = {}

    def _client_sampling(self, round_idx: int) -> List[int]:
        self._round_dc: List[Any] = []
        return super()._client_sampling(round_idx)

    def _train_client(self, client, w_global) -> Any:
        cid = client.client_idx
        c_i = self.c_clients.get(cid)
        if c_i is None:
            c_i = tree_zeros_like(params_of(w_global))
        names = list(c_i)
        c = [self.c_server[k] for k in names]
        c_minus_ci = dict(zip(names, torch._foreach_sub(c, [c_i[k] for k in names])))
        self.trainer.set_model_params(w_global)
        res = self.trainer.train(client.local_training_data, None, self.args, extra=c_minus_ci)
        k_lr = max(float(res.steps), 1.0) * self.lr
        w_g, w_i = params_of(w_global), params_of(res.variables)
        new_ci = {k: c_i[k] - self.c_server[k] + (w_g[k] - w_i[k]) / k_lr for k in names}
        self._round_dc.append(tree_sub(new_ci, c_i))
        self.c_clients[cid] = new_ci
        return res.variables

    def server_update(self, w_locals: List[Tuple[float, Any]]) -> Any:
        new_global = super().server_update(w_locals)
        if self._round_dc:  # c <- c + (1/N) * sum_i dc_i
            dc = tree_sum(self._round_dc)
            scale = 1.0 / float(self.args.client_num_in_total)
            self.c_server = {k: c + scale * dc[k] for k, c in self.c_server.items()}
        return new_global
