"""Default ServerAggregator of the port (counterpart of
``fedml_tpu/ml/aggregator/default_aggregator.py``): holds the global
variables and evaluates them in fixed-size masked batches."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...core.alg_frame.server_aggregator import ServerAggregator
from ..engine.train import load_variables, make_eval_fn, pad_to


class DefaultServerAggregator(ServerAggregator):
    def __init__(self, model, args):
        super().__init__(model, args)
        self.variables = None
        self._eval_fn = make_eval_fn(model)
        self._eval_batch = int(getattr(args, "eval_batch_size", 256))

    def get_model_params(self) -> Any:
        return self.variables

    def set_model_params(self, model_parameters: Any) -> None:
        self.variables = model_parameters

    def test(self, test_data, device, args):
        """test_data: (x, y) numpy arrays -> dict(test_correct, test_loss,
        test_total).  Sums stay on the device until the end: one sync."""
        load_variables(self.model, self.variables)
        x, y = test_data
        b = self._eval_batch
        n = len(y)
        device = next(self.model.parameters()).device
        xs_all = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        ys_all = torch.from_numpy(np.ascontiguousarray(y)).to(device)
        sums = torch.zeros(3, dtype=torch.float32, device=device)
        for s in range(max(1, -(-n // b))):
            xs, ys = xs_all[s * b:(s + 1) * b], ys_all[s * b:(s + 1) * b]
            m = torch.ones((xs.shape[0],), dtype=torch.float32, device=device)
            if xs.shape[0] < b:  # pad the tail batch to the one batch shape
                pad_n = b - xs.shape[0]
                xs, ys = pad_to(xs, b), pad_to(ys, b)
                m = torch.cat([m, torch.zeros((pad_n,), dtype=torch.float32, device=device)])
            sums += torch.stack(self._eval_fn(xs, ys, m))
        loss_sum, correct, total = sums.tolist()
        return {
            "test_correct": correct,
            "test_loss": loss_sum,
            "test_total": max(total, 1.0),
        }
