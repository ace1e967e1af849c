"""Classical vertical (feature-split) federated learning of the port's
``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/classical_vertical_fl/vfl_api.py``,
``VerticalFLAPI``).

``vfl_party_num`` parties hold disjoint slices of the features of the same
samples (``np.array_split`` of the feature columns); the guest holds the
labels.  Each round is one step of full-batch gradient descent over the
whole training split: every party computes its partial logits x_k w_k, the
guest sums them with its bias, takes the mean CE, and each party steps its
own weights by ``learning_rate`` times the gradient (``client_optimizer`` is
not read, as in the JAX twin).  Multi-hot labels (NUS-WIDE's) become the
index of their first largest entry.  The eval, at ``round_idx %
frequency_of_the_test == 0`` and after the last round, reports the test
accuracy and the loss before the round's step, each rounded to 4 decimals.

A party's weights start at 0.01 N(0, 1) from the CPU generator of (seed,
8161, party) (``utils/rng.py``), where the JAX twin folds the party into
``PRNGKey(seed)``; the bias starts at zero.  No trust hook runs: each is
refused when the object is built (the table is in
``simulation/sp/__init__.py``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ....device import fp32_matmul
from ....ml.trainer.cls_trainer import to_device
from ....utils.metrics import MetricsLogger
from ....utils.rng import VFL_WEIGHT_SALT, seeded_generator
from ..fedavg.fedavg_api import own_loop_setup

logger = logging.getLogger(__name__)


class VerticalFLAPI:
    def __init__(self, args, device, dataset, model=None):
        self.args = args
        self.freq = own_loop_setup(args, "VerticalFLAPI")
        self.device = torch.device(device)
        (_, _, (x_tr, y_tr), (x_te, y_te), *_rest, self.class_num) = dataset
        self.parties = int(getattr(args, "vfl_party_num", 2))
        x_tr = np.asarray(x_tr, np.float32).reshape(len(y_tr), -1)
        x_te = np.asarray(x_te, np.float32).reshape(len(y_te), -1)
        y_tr, y_te = np.asarray(y_tr), np.asarray(y_te)
        if y_tr.ndim > 1:  # multi-hot -> the dominant concept
            y_tr, y_te = y_tr.argmax(axis=-1), y_te.argmax(axis=-1)
        self.feature_slices = np.array_split(np.arange(x_tr.shape[1]), self.parties)
        self.x_tr = [to_device(x_tr[:, s], self.device) for s in self.feature_slices]
        self.x_te = [to_device(x_te[:, s], self.device) for s in self.feature_slices]
        self.y_tr = to_device(y_tr.astype(np.int64), self.device)
        self.y_te = to_device(y_te.astype(np.int64), self.device)
        seed = int(getattr(args, "random_seed", 0))
        self.w = [(0.01 * torch.randn((len(s), self.class_num),
                                      generator=seeded_generator((seed, VFL_WEIGHT_SALT, k))))
                  .to(self.device) for k, s in enumerate(self.feature_slices)]
        self.b = torch.zeros((self.class_num,), device=self.device)
        self.lr = float(getattr(args, "learning_rate", 0.1))
        self.metrics = MetricsLogger(args)
        self.round_times: List[float] = []
        self.round_losses: List[float] = []

    @staticmethod
    def _logits(xs, ws, b) -> torch.Tensor:
        """The guest's sum of the parties' partial logits, plus its bias."""
        z = xs[0] @ ws[0]
        for x, w in zip(xs[1:], ws[1:]):
            z = z + x @ w
        return z + b

    def _step(self) -> torch.Tensor:
        ws = [w.requires_grad_(True) for w in self.w]
        b = self.b.requires_grad_(True)
        loss = F.cross_entropy(self._logits(self.x_tr, ws, b), self.y_tr)
        grads = torch.autograd.grad(loss, ws + [b])
        with torch.no_grad():
            self.w = [w - self.lr * g for w, g in zip(ws, grads)]
            self.b = b - self.lr * grads[-1]
        return loss.detach()

    def train(self) -> Dict[str, Any]:
        with fp32_matmul():
            return self._train()

    def _train(self) -> Dict[str, Any]:
        rounds = int(self.args.comm_round)
        last: Dict[str, Any] = {}
        for r in range(rounds):
            t0 = time.time()
            loss = float(self._step())
            self.round_losses.append(loss)
            self.round_times.append(time.time() - t0)
            if r % self.freq == 0 or r == rounds - 1:
                with torch.no_grad():
                    z = self._logits(self.x_te, self.w, self.b)
                    acc = float((z.argmax(dim=1) == self.y_te).float().mean())
                last = {"round": r, "test_acc": round(acc, 4), "train_loss": round(loss, 4)}
                self.metrics.log(last)
        return last
