"""FedNAS of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/fednas/fednas_api.py``, ``FedNASAPI``): federated
DARTS search.

Each round samples its clients by ``core.sampling.client_sampling``; each
client searches from the global weights w and architecture logits alpha
(``search_client``): ``epochs`` passes over its data in order, in full
batches only (a trailing partial batch is dropped), each step the mean CE's
gradient to both (the single-level, MiLeNAS-style joint update), SGD with
momentum 0.9 at ``learning_rate`` on w and adam at ``arch_learning_rate`` on
alpha, both fresh for every client (``client_optimizer`` is not read, as in
the JAX twin).  The server takes the ``local_num``-weighted mean of both
(``weighted_mean``).  The eval, at ``round_idx % frequency_of_the_test ==
0`` and after the last round, runs the global test set in batches of 256;
after the last round the genotype is derived (``derive_architecture``).

A ``DARTSNetwork`` passed in is kept; one is built otherwise.  The weights
start from ``random_seed`` and the alphas from ``init_alphas`` (a CPU
generator: the same numbers on the card and the CPU); the tests transplant
JAX's.  No trust hook runs: each is refused when the object is built (the
table is in ``simulation/sp/__init__.py``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ....core.aggregate import weighted_mean
from ....core.sampling import client_sampling
from ....device import fp32_matmul
from ....ml.engine.train import get_variables, init_variables, load_variables
from ....ml.trainer.cls_trainer import to_device
from ....models.darts import DARTSNetwork, derive_architecture, init_alphas
from ....utils.metrics import MetricsLogger
from ..fedavg.fedavg_api import own_loop_setup

logger = logging.getLogger(__name__)

EVAL_BATCH = 256


def search_client(net: DARTSNetwork, params, alphas: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor, bs: int, epochs: int, w_lr: float, a_lr: float):
    """One client's search from (``params``, ``alphas``) on its rows ``x``,
    ``y``: ``epochs`` passes of full batches in order, SGD with momentum 0.9
    on the weights and adam on the alphas, both fresh.  Returns the client's
    weights and alphas, the sum of its steps' losses (on the device) and its
    step count."""
    load_variables(net, params)
    net.train()
    a = alphas.detach().clone().requires_grad_(True)
    w_opt = torch.optim.SGD(net.parameters(), lr=w_lr, momentum=0.9)
    a_opt = torch.optim.Adam([a], lr=a_lr)
    loss_sum, steps = torch.zeros((), device=x.device), 0
    for _ in range(epochs):
        for s in range(0, len(y) - bs + 1, bs):
            loss = F.cross_entropy(net(x[s:s + bs], a), y[s:s + bs])
            w_opt.zero_grad(set_to_none=True)
            a_opt.zero_grad(set_to_none=True)
            loss.backward()
            w_opt.step()
            a_opt.step()
            loss_sum += loss.detach()
            steps += 1
    return get_variables(net), a.detach(), loss_sum, steps


def build_network(model, class_num: int, x_sample: np.ndarray) -> DARTSNetwork:
    """The ``DARTSNetwork`` passed in, else one for the data's channels."""
    if isinstance(model, DARTSNetwork):
        return model
    x = np.asarray(x_sample)
    channels = int(x.shape[-1]) if x.ndim == 4 else 1
    return DARTSNetwork(num_classes=class_num, in_channels=channels, device="meta")


@torch.no_grad()
def eval_accuracy(net: DARTSNetwork, params, alphas, test_global, device) -> float:
    """The global test set's accuracy, in batches of 256."""
    x, y = test_global
    load_variables(net, params)
    net.eval()
    correct = torch.zeros((), device=device)
    for s in range(0, len(y), EVAL_BATCH):
        logits = net(to_device(np.asarray(x[s:s + EVAL_BATCH], np.float32), device), alphas)
        correct += (logits.argmax(dim=-1) == to_device(y[s:s + EVAL_BATCH], device)).sum()
    return float(correct) / max(len(y), 1)


class FedNASAPI:
    def __init__(self, args, device, dataset, model=None):
        self.args = args
        self.freq = self._checks(args)
        self.device = torch.device(device)
        (_tn, _ten, _tg, self.test_global, self.local_num, self.local_train, _lt,
         self.class_num) = dataset
        self.bs = int(getattr(args, "batch_size", 32))
        seed = int(getattr(args, "random_seed", 0))
        self.w_lr = float(getattr(args, "learning_rate", 0.025))
        self.a_lr = float(getattr(args, "arch_learning_rate", 3e-3))
        self.net = build_network(model, self.class_num, next(iter(self.local_train.values()))[0])
        self.params = init_variables(self.net, self.device, seed=seed)
        self.alphas = init_alphas(seed, self.device)
        self.metrics = MetricsLogger(args)
        self.eval_history: List[Dict[str, Any]] = []
        self.round_times: List[float] = []
        self.round_losses: List[float] = []  # mean search loss a step
        self._data: Dict[int, Any] = {}

    def _checks(self, args) -> int:
        """``own_loop_setup``'s checks; returns ``frequency_of_the_test``
        (refused at 0 or below: JAX's ``round_idx % freq`` fails there)."""
        return own_loop_setup(args, type(self).__name__)

    def _round_clients(self, round_idx: int) -> List[Tuple[int, float]]:
        """(client, weight) of each client that searches in the round: the
        sampled ones in sampled order, weighted by ``local_num``."""
        sampled = client_sampling(round_idx, int(self.args.client_num_in_total),
                                  int(self.args.client_num_per_round))
        return [(int(c), float(self.local_num[int(c)])) for c in sampled]

    def _client(self, cid: int):
        if cid not in self._data:
            x, y = self.local_train[cid]
            self._data[cid] = (to_device(np.asarray(x, np.float32), self.device),
                               to_device(np.asarray(y), self.device).long())
        return self._data[cid]

    def train(self) -> Dict[str, Any]:
        with fp32_matmul():
            return self._train()

    def _train(self) -> Dict[str, Any]:
        comm_round = int(self.args.comm_round)
        epochs = int(getattr(self.args, "epochs", 1))
        last: Dict[str, Any] = {}
        for round_idx in range(comm_round):
            t0 = time.time()
            locals_: List[Tuple[float, Any]] = []
            alpha_locals: List[Tuple[float, Any]] = []
            loss_sum, steps = torch.zeros((), device=self.device), 0
            for cid, n in self._round_clients(round_idx):
                x, y = self._client(cid)
                params, alphas, loss, k = search_client(self.net, self.params, self.alphas, x, y,
                                                        self.bs, epochs, self.w_lr, self.a_lr)
                loss_sum += loss
                steps += k
                locals_.append((n, params))
                alpha_locals.append((n, {"alphas": alphas}))
            self.params = weighted_mean(locals_)
            self.alphas = weighted_mean(alpha_locals)["alphas"]
            self.round_losses.append(float(loss_sum) / max(steps, 1))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.round_times.append(time.time() - t0)
            self.metrics.log({"round": round_idx})
            if self.freq > 0 and (round_idx % self.freq == 0 or round_idx == comm_round - 1):
                last = self._test_global(round_idx)
        last["genotype"] = derive_architecture(self.alphas)
        logger.info("derived architecture: %s", last["genotype"])
        return last

    def _test_global(self, round_idx: int) -> Dict[str, Any]:
        acc = eval_accuracy(self.net, self.params, self.alphas, self.test_global, self.device)
        out = {"round": round_idx, "test_acc": round(acc, 4)}
        self.eval_history.append(out)
        self.metrics.log(out)
        logger.info("%s eval: %s", type(self).__name__, out)
        return out
