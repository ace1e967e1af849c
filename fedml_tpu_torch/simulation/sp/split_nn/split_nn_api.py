"""Split learning of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/split_nn/split_nn_api.py``, ``SplitNNAPI``).

The model is cut in two: the clients' front (``_Front``: a flatten and a
dense layer of ``split_hidden`` units with a relu) and the server's back
(``_Back``: a dense layer of 64 units with a relu, then the class logits).
One front is relayed from client to client: each round every client, in id
order (all of them, not a sample), trains it on its own data in turn,
``max(1, n // batch_size)`` full batches in order (a client smaller than a
batch is tiled to one batch; an empty one is skipped).  A step sends the cut
layer's activations up, the server takes the mean CE and its gradient to
its own weights and to the activations, and the activations' gradient
travels back for the front's; each half then takes a plain SGD step at
``learning_rate`` (``client_optimizer`` is not read, as in the JAX twin).
The eval, at ``round_idx % frequency_of_the_test == 0`` and after the last
round, runs the whole test set at once: the accuracy rounded to 4 decimals.

The front is initialised from seed 0 and the back from seed 999 (the JAX
twin's ``PRNGKey(0)`` and ``PRNGKey(999)``; torch draws other numbers, so
the tests transplant the flax trees).  No trust hook runs: each is refused
when the object is built (the table is in ``simulation/sp/__init__.py``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....device import fp32_matmul
from ....ml.engine.train import get_variables, init_variables
from ....ml.trainer.cls_trainer import to_device
from ....models.resnet import flax_init
from ....utils.metrics import MetricsLogger
from ..fedavg.fedavg_api import own_loop_setup

logger = logging.getLogger(__name__)


class _Front(nn.Module):
    def __init__(self, in_features: int, hidden: int = 128, device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.fc1(x.reshape(x.shape[0], -1)))

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)


class _Back(nn.Module):
    def __init__(self, hidden: int, classes: int = 10, device=None):
        super().__init__()
        self.fc2 = nn.Linear(hidden, 64, device=device)
        self.head = nn.Linear(64, classes, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.head(F.relu(self.fc2(h)))

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)


class SplitNNAPI:
    def __init__(self, args, device, dataset, model=None):
        self.args = args
        self.freq = own_loop_setup(args, type(self).__name__)
        self.device = torch.device(device)
        (_, _, _tg, (x_te, y_te), self.local_num, self.local_train, _lt,
         self.class_num) = dataset
        self.x_te = to_device(np.asarray(x_te, np.float32), self.device)
        self.y_te = to_device(np.asarray(y_te), self.device).long()
        hidden = int(getattr(args, "split_hidden", 128))
        in_features = int(np.prod(np.asarray(self.local_train[0][0]).shape[1:]))
        self.front = _Front(in_features, hidden, device="meta")
        self.back = _Back(hidden, self.class_num, device="meta")
        init_variables(self.front, self.device, seed=0)
        init_variables(self.back, self.device, seed=999)
        self.lr = float(getattr(args, "learning_rate", 0.1))
        self.bs = int(getattr(args, "batch_size", 32))
        self.metrics = MetricsLogger(args)
        self._data: Dict[int, Any] = {}
        self.round_times: List[float] = []
        self.round_losses: List[float] = []

    @property
    def front_params(self) -> Dict[str, torch.Tensor]:
        return get_variables(self.front)

    @property
    def back_params(self) -> Dict[str, torch.Tensor]:
        return get_variables(self.back)

    def _split_step(self, x: torch.Tensor, y: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One exchange: the front's forward to the cut layer, the server's
        loss (the mean CE, over the rows of ``mask`` when given) and
        gradients, the cut gradient back through the front, then plain SGD on
        both halves."""
        h = self.front(x)
        cut = h.detach().requires_grad_(True)  # what crosses to the server
        back = list(self.back.parameters())
        if mask is None:
            loss = F.cross_entropy(self.back(cut), y)
        else:
            per = F.cross_entropy(self.back(cut), y, reduction="none")
            loss = (per * mask).sum() / mask.sum().clamp_min(1.0)
        *g_back, g_cut = torch.autograd.grad(loss, back + [cut])
        front = list(self.front.parameters())
        g_front = torch.autograd.grad(h, front, grad_outputs=g_cut)
        with torch.no_grad():
            torch._foreach_add_(front + back, list(g_front) + g_back, alpha=-self.lr)
        return loss.detach()

    def _client(self, cid: int):
        """A client's data on the device, tiled to one batch when smaller
        (None when empty)."""
        if cid not in self._data:
            x, y = self.local_train[cid]
            if len(y) == 0:
                self._data[cid] = None
            else:
                x, y = np.asarray(x, np.float32), np.asarray(y)
                if len(y) < self.bs:  # tile small clients to one full batch
                    reps = -(-self.bs // len(y))
                    x = np.tile(x, (reps,) + (1,) * (x.ndim - 1))[:self.bs]
                    y = np.tile(y, reps)[:self.bs]
                self._data[cid] = (to_device(x, self.device), to_device(y, self.device).long())
        return self._data[cid]

    def train(self) -> Dict[str, Any]:
        with fp32_matmul():
            return self._train()

    def _train(self) -> Dict[str, Any]:
        rounds = int(self.args.comm_round)
        bs = self.bs
        last: Dict[str, Any] = {}
        for r in range(rounds):
            t0 = time.time()
            loss_sum, steps = torch.zeros((), device=self.device), 0
            for cid in range(int(self.args.client_num_in_total)):  # the relay
                data = self._client(cid)
                if data is None:
                    continue
                x, y = data
                for s in range(max(1, len(y) // bs)):
                    loss_sum += self._split_step(x[s * bs:(s + 1) * bs], y[s * bs:(s + 1) * bs])
                    steps += 1
            self.round_losses.append(float(loss_sum) / max(steps, 1))
            self.round_times.append(time.time() - t0)
            if r % self.freq == 0 or r == rounds - 1:
                last = self._evaluate(r)
        return last

    @torch.no_grad()
    def _evaluate(self, r: int) -> Dict[str, Any]:
        logits = self.back(self.front(self.x_te))
        acc = float((logits.argmax(dim=1) == self.y_te).float().mean())
        out = {"round": r, "test_acc": round(acc, 4)}
        self.metrics.log(out)
        return out
