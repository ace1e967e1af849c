"""Classification ClientTrainer over the port's engine (counterpart of
``fedml_tpu/ml/trainer/cls_trainer.py``, ``ModelTrainerCLS``).

``train`` moves the client's numpy arrays to the trainer's device, pads them
to a bucket (``padded_size``: the next power-of-two multiple of the batch,
so few shapes recur) and runs ``ml.engine.train.build_local_train``'s
function for that ``(padded_n, batch_size)``, built once and kept.  The
shuffles are seeded from (``random_seed``, round, client id), the
counterpart of the JAX trainer's ``fold_in(fold_in(rng, round), client)``:
a pure function of the three, so a replay draws the same batches.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ...core.alg_frame.client_trainer import ClientTrainer
from ..engine.train import build_local_train, load_variables, make_eval_fn, pad_to


def to_device(a, device: torch.device) -> torch.Tensor:
    """A numpy array (or tensor) as a tensor on ``device``."""
    if torch.is_tensor(a):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class ModelTrainerCLS(ClientTrainer):
    loss_kind = "ce"

    def __init__(self, model, args, grad_hook=None):
        super().__init__(model, args)
        self.module = model
        self.variables = None
        self.grad_hook = grad_hook  # per-step gradient rewrite (FedProx/SCAFFOLD/FedDyn)
        self._train_fns: Dict[Tuple[int, int], Any] = {}  # (padded_n, bs) -> fn
        self._eval_fn = make_eval_fn(model)
        self.seed = int(getattr(args, "random_seed", 0))
        self.round_idx = 0
        self.last_result = None

    def get_model_params(self):
        return self.variables

    def set_model_params(self, model_parameters):
        self.variables = model_parameters

    def _device(self) -> torch.device:
        return next(self.module.parameters()).device

    def _fn_for(self, padded_n: int, batch_size: int):
        key = (padded_n, batch_size)
        if key not in self._train_fns:
            self._train_fns[key] = build_local_train(
                self.module, self.args, batch_size, padded_n, loss=self.loss_kind,
                grad_hook=self.grad_hook)
        return self._train_fns[key]

    @staticmethod
    def padded_size(n: int, batch_size: int) -> int:
        """A client's size rounded up to a bucket: the next power-of-two
        multiple of ``batch_size``."""
        n = max(n, batch_size)
        bucket = batch_size
        while bucket < n:
            bucket *= 2
        return bucket

    def train(self, train_data, device, args, extra=None):
        x, y = train_data
        n = len(y)
        bs = int(getattr(args, "batch_size", 32))
        padded_n = self.padded_size(n, bs)
        dev = self._device()
        xp = pad_to(to_device(x, dev), padded_n)
        yp = pad_to(to_device(y, dev), padded_n)
        result = self._fn_for(padded_n, bs)(
            self.variables, xp, yp, n, seed=(self.seed, int(self.round_idx), int(self.id or 0)),
            extra=extra)
        self.variables = result.variables
        self.last_result = result
        return result

    @torch.no_grad()
    def eval_logits(self, x) -> torch.Tensor:
        """fp32 logits of the trainer's variables on ``x`` in one forward
        (eval mode), on the trainer's device: the task trainers' evals."""
        load_variables(self.module, self.variables)
        self.module.eval()
        return self.module(to_device(x, self._device())).float()

    def test(self, test_data, device, args):
        x, y = test_data
        dev = self._device()
        xs, ys = to_device(x, dev), to_device(y, dev)
        load_variables(self.module, self.variables)
        loss, correct, total = self._eval_fn(xs, ys, torch.ones((xs.shape[0],), device=dev))
        return {"test_correct": float(correct), "test_loss": float(loss),
                "test_total": float(total)}
