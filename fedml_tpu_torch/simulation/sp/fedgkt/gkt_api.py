"""FedGKT of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/fedgkt/gkt_api.py``, ``FedGKTAPI``): group
knowledge transfer.

Clients train a small edge net (``GKTClientNet``) and upload feature maps,
logits and labels, never weights; the server trains a large tower
(``GKTServerNet``, ``gkt_server_width`` x ``gkt_server_blocks``) on the union
of the clients' features and sends back fresh logits for each sample.  A
round:

* each sampled client, in sampled order, takes its first ``n - n %
  batch_size`` rows (a client smaller than a batch is ``np.resize``d to one
  batch) and trains its own edge params, which are never aggregated (the
  shared initial params before its first contact), with a fresh SGD with
  momentum 0.9 at ``learning_rate``: ``epochs`` passes of full batches in
  order, each step on CE + ``gkt_alpha`` x KL(server || client) at
  temperature ``gkt_temperature`` scaled by T², the KL term switched off
  (``has_kd`` 0) until the server has sent this client logits;
* the client extracts (features, logits) of its rows in batches;
* the server, with a fresh SGD with momentum 0.9, trains
  ``gkt_server_epochs`` passes over the transfer set in sampled order, full
  batches, on CE + ``gkt_alpha`` x KL(client || server);
* the server's logits are drawn anew for every client of the round (those
  of earlier rounds' other clients are dropped, as in the JAX twin).

The eval, at ``round_idx % frequency_of_the_test == 0`` and after the last
round, runs the global test set in batches of 256 through the edge params of
the round's first sampled client and the server tower.  A ``GKTClientNet``
passed in is kept; any other model is ignored, as the JAX twin ignores it.
``client_optimizer`` is not read.  The tests transplant JAX's initial
params.  No trust hook runs: each is refused when the object is built (the
table is in ``simulation/sp/__init__.py``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ....core.sampling import client_sampling
from ....device import fp32_matmul
from ....ml.engine.train import get_variables, init_variables, load_variables
from ....ml.trainer.cls_trainer import to_device
from ....models.gkt import GKTClientNet, GKTServerNet
from ....utils.metrics import MetricsLogger
from ..fedavg.fedavg_api import own_loop_setup

logger = logging.getLogger(__name__)

EVAL_BATCH = 256


def _kl(p_logits: torch.Tensor, q_logits: torch.Tensor, temperature: float,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(softmax(p/T) || softmax(q/T)) averaged over the batch (over the
    rows of ``mask`` when given), times T²."""
    p = F.log_softmax(p_logits / temperature, dim=-1)
    q = F.log_softmax(q_logits / temperature, dim=-1)
    per = torch.sum(torch.exp(p) * (p - q), dim=-1)
    if mask is not None:
        return (per * mask).sum() / mask.sum().clamp_min(1.0) * temperature ** 2
    return torch.mean(per) * temperature ** 2


def _batched(n: int, bs: int):
    return [(s, min(s + bs, n)) for s in range(0, n, bs)]


class FedGKTAPI:
    def __init__(self, args, device, dataset, model=None):
        self.args = args
        self.freq = own_loop_setup(args, type(self).__name__)
        self.device = torch.device(device)
        (_tn, _ten, _tg, self.test_global, self.local_num, self.local_train, _lt,
         self.class_num) = dataset
        self.temperature = float(getattr(args, "gkt_temperature", 3.0))
        self.alpha = float(getattr(args, "gkt_alpha", 1.0))  # KD weight
        self.server_epochs = int(getattr(args, "gkt_server_epochs", 1))
        self.bs = int(getattr(args, "batch_size", 32))
        self.lr = float(getattr(args, "learning_rate", 0.01))
        seed = int(getattr(args, "random_seed", 0))
        if isinstance(model, GKTClientNet):
            self.client_net = model
        else:
            x = np.asarray(next(iter(self.local_train.values()))[0])
            self.client_net = GKTClientNet(num_classes=self.class_num, device="meta",
                                           in_channels=int(x.shape[-1]) if x.ndim == 4 else 1)
        self.server_net = GKTServerNet(
            num_classes=self.class_num, width=int(getattr(args, "gkt_server_width", 64)),
            blocks=int(getattr(args, "gkt_server_blocks", 3)),
            in_channels=self.client_net.width, device="meta")
        # per-client edge params (never aggregated: GKT's defining property)
        self.client_params: Dict[int, Dict[str, torch.Tensor]] = {}
        self._proto_client_params = init_variables(self.client_net, self.device, seed=seed)
        init_variables(self.server_net, self.device, seed=seed + 1)
        # per-client server logits of the previous round (the downloaded
        # knowledge); empty before round 0
        self.server_logits: Dict[int, torch.Tensor] = {}
        self.metrics = MetricsLogger(args)
        self.eval_history: List[Dict[str, Any]] = []
        self.round_times: List[float] = []
        self.round_losses: List[float] = []

    @property
    def server_params(self) -> Dict[str, torch.Tensor]:
        return get_variables(self.server_net)

    def _client_rows(self, cid: int):
        """The client's first ``n - n % bs`` rows on the device, or its rows
        ``np.resize``d to one batch when it has fewer."""
        x, y = self.local_train[cid]
        x, y = np.asarray(x, np.float32), np.asarray(y)
        if len(y) >= self.bs:
            n = len(y) - len(y) % self.bs
            x, y = x[:n], y[:n]
        else:
            x, y = np.resize(x, (self.bs,) + x.shape[1:]), np.resize(y, self.bs)
        return to_device(x, self.device), to_device(y, self.device).long()

    def _train_client(self, cid: int, epochs: int):
        """One client's local training and upload: (features, logits, labels)."""
        x, y = self._client_rows(cid)
        net = self.client_net
        load_variables(net, self.client_params.get(cid, self._proto_client_params))
        net.train()
        opt = torch.optim.SGD(net.parameters(), lr=self.lr, momentum=0.9)
        s_log = self.server_logits.get(cid)  # None: no KD before the first contact
        for _ in range(epochs):
            for s, e in _batched(len(y), self.bs):
                if e - s < self.bs:
                    continue
                _, logits = net(x[s:e])
                loss = F.cross_entropy(logits, y[s:e])
                if s_log is not None:
                    loss = loss + self.alpha * _kl(s_log[s:e], logits, self.temperature)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        self.client_params[cid] = get_variables(net)
        with torch.no_grad():  # extract in fixed-size batches
            parts = [net(x[s:e]) for s, e in _batched(len(y), self.bs)]
        return (torch.cat([f for f, _ in parts]), torch.cat([lg for _, lg in parts]), y)

    def _train_server(self, transfer) -> torch.Tensor:
        net = self.server_net
        net.train()
        opt = torch.optim.SGD(net.parameters(), lr=self.lr, momentum=0.9)
        loss = torch.zeros((), device=self.device)
        for _ in range(self.server_epochs):
            for feats, c_logits, y in transfer.values():
                for s, e in _batched(len(y), self.bs):
                    if e - s < self.bs:
                        continue
                    logits = net(feats[s:e])
                    loss = F.cross_entropy(logits, y[s:e]) + self.alpha * _kl(
                        c_logits[s:e], logits, self.temperature)
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    opt.step()
        return loss.detach()

    def train(self) -> Dict[str, Any]:
        with fp32_matmul():
            return self._train()

    def _train(self) -> Dict[str, Any]:
        comm_round = int(self.args.comm_round)
        epochs = int(getattr(self.args, "epochs", 1))
        last: Dict[str, Any] = {}
        for round_idx in range(comm_round):
            t0 = time.time()
            client_ids = [int(c) for c in client_sampling(
                round_idx, int(self.args.client_num_in_total),
                int(self.args.client_num_per_round))]
            transfer = {cid: self._train_client(cid, epochs) for cid in client_ids}
            loss = self._train_server(transfer)
            with torch.no_grad():  # download fresh knowledge, in fixed-size batches
                self.server_net.eval()
                self.server_logits = {
                    cid: torch.cat([self.server_net(feats[s:e])
                                    for s, e in _batched(len(y), self.bs)])
                    for cid, (feats, _cl, y) in transfer.items()}
            self.round_losses.append(float(loss))
            self.round_times.append(time.time() - t0)
            self.metrics.log({"round": round_idx, "server_loss": self.round_losses[-1]})
            if round_idx % self.freq == 0 or round_idx == comm_round - 1:
                last = self._test_global(round_idx, client_ids[0])
        return last

    @torch.no_grad()
    def _test_global(self, round_idx: int, probe_cid: int) -> Dict[str, Any]:
        """Edge extractor (the probe client's) + server tower on the global
        test set."""
        x, y = self.test_global
        load_variables(self.client_net, self.client_params.get(probe_cid,
                                                               self._proto_client_params))
        self.client_net.eval()
        self.server_net.eval()
        correct = torch.zeros((), device=self.device)
        for s, e in _batched(len(y), EVAL_BATCH):
            feats, _ = self.client_net(to_device(np.asarray(x[s:e], np.float32), self.device))
            logits = self.server_net(feats)
            correct += (logits.argmax(dim=-1) == to_device(y[s:e], self.device)).sum()
        out = {"round": round_idx, "test_acc": round(float(correct) / max(len(y), 1), 4)}
        self.eval_history.append(out)
        self.metrics.log(out)
        logger.info("fedgkt eval: %s", out)
        return out
