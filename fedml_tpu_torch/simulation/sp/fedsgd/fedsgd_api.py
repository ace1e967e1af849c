"""FedSGD of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/fedsgd/fedsgd_api.py``): one full-batch gradient
step a round, the FedAvg paper's baseline.

Each client uploads the gradient of the masked mean cross-entropy of its
whole local data, padded to the trainer's bucket (``padded_size``), at the
global model, in eval mode (no dropout); the server takes one step
``p - learning_rate * weighted_mean(grads)``.  One gradient function is
built a padded size and kept.  On the card a TransformerLM's gradient is one
forward and backward over the padded client: K1 once and K2/K3 once a layer.

The client's training is replaced, so the trainer's after-hook (local DP)
does not run, and the aggregate is this rule, not the aggregator's: both
hooks are refused, as the JAX twin skips them.  The gradient is of the
classification CE, as in the JAX twin, so a dataset whose loss is another
(tag prediction's BCE, span extraction's, seq2seq's with its -1 labels) is
refused when the object is built, where the JAX twin takes the CE of those
labels.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from ....core.aggregate import weighted_mean
from ....ml.engine.train import load_variables, pad_to, softmax_ce_loss
from ....ml.trainer.cls_trainer import to_device
from ...xla.algorithms import params_of
from ..fedavg.fedavg_api import LOCAL_DP, ON_DEFENSE, FedAvgAPI


class FedSGDAPI(FedAvgAPI):
    SKIPPED_HOOKS = (LOCAL_DP, ON_DEFENSE)

    def __init__(self, args, device, dataset, model):
        super().__init__(args, device, dataset, model)
        if self.trainer.loss_kind != "ce":
            raise NotImplementedError(
                f"FedSGD's client gradient is of the ce loss; dataset "
                f"{getattr(args, 'dataset', None)!r} trains with the {self.trainer.loss_kind} "
                "loss (its JAX twin takes the ce loss of these labels)")
        self._grad_fns: Dict[int, Callable] = {}
        self.server_lr = float(getattr(args, "learning_rate", 0.01))

    def _make(self, padded_n: int) -> Callable:
        module = self.module
        params = dict(module.named_parameters())
        rows = torch.arange(padded_n, device=self.device)

        def grad_of(variables, x, y, n_valid: int) -> Dict[str, torch.Tensor]:
            load_variables(module, variables)
            module.eval()
            mask = (rows < n_valid).float()
            loss, _ = softmax_ce_loss(module(x), y, mask)
            grads = torch.autograd.grad(loss, list(params.values()))
            return dict(zip(params, grads))

        return grad_of

    def _train_client(self, client, w_global) -> Any:
        """The client's gradient at ``w_global``: the upload's slot carries it."""
        x, y = client.local_training_data
        n = len(y)
        padded_n = self.trainer.padded_size(n, int(getattr(self.args, "batch_size", 32)))
        if padded_n not in self._grad_fns:
            self._grad_fns[padded_n] = self._make(padded_n)
        return self._grad_fns[padded_n](
            w_global, pad_to(to_device(x, self.device), padded_n),
            pad_to(to_device(y, self.device), padded_n), n)

    def server_update(self, grad_locals: List[Tuple[float, Any]]) -> Any:
        grad_locals = self.aggregator.on_before_aggregation(grad_locals)
        avg_grad = weighted_mean(grad_locals)
        params = params_of(self.w_global)
        new_params = {k: p - self.server_lr * avg_grad[k] for k, p in params.items()}
        return self.aggregator.on_after_aggregation(dict(self.w_global, **new_params))
