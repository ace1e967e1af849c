"""The in-mesh split-computation simulators of the port (counterpart of
``fedml_tpu/simulation/xla/split.py``): ``VFLInMeshAPI``,
``SplitNNInMeshAPI`` and ``GKTInMeshAPI``, which ``SimulatorXLA`` builds for
``federated_optimizer`` ``classical_vertical``, ``split_nn`` and ``fedgkt``,
and ``_pad_clients``, the client packing that the in-mesh rounds share.

The JAX package compiles each into XLA programs over a device mesh, the
algorithm's exchange a mesh collective.  The port has one card, so every
``shard_map`` over the ``party`` or ``client`` axis becomes a loop over that
axis's slots and every ``psum`` a plain sum:

* ``VFLInMeshAPI``: one weight matrix ``w [features, classes]`` over all the
  features (0.01 N(0, 1) from the CPU generator of (seed, 8171),
  ``utils/rng.py``; JAX draws from ``PRNGKey(seed)``) and a zero bias.  A
  round is one full-batch step with the hand-written gradient
  ``(softmax - onehot) / B``; multi-hot labels become their argmax.  The
  feature axis is not padded (one device divides any width), and
  ``vfl_party_num`` is kept, as in JAX, without changing the arithmetic.
* ``SplitNNInMeshAPI``: the ``sp`` twin's front and back, initialised as
  there.  On one card there is one relay chain over all the clients in id
  order.  Each client is padded to ``padded_n`` rows and walked in
  ``padded_n / batch_size`` batches, each step's CE the mean over its real
  rows; a batch with no real row has a zero gradient and leaves plain SGD's
  params as they are, so it is skipped.  The JAX merge of the chains,
  ``psum(w * t) / psum(w)``, is the identity on one chain up to one rounding
  and is not done.  The round's loss is the batches' sample-weighted mean.
* ``GKTInMeshAPI``: the ``sp`` twin's models, initial draws, KL (here over
  the real rows) and eval.  Each client's edge params are its entry in a
  per-client table (the shared proto until its first contact), gathered
  for the round's clients and written back, never averaged.  Each client trains ``padded_n /
  batch_size * epochs`` batches of its padded rows (batch ``i mod
  n_batches``) with a fresh SGD with momentum 0.9: a batch with no real row
  has a zero gradient but still moves the params by the momentum, so it is
  run.  The KD term is off until the client's first contact.  The server
  trains on the transfer set slot by slot, batch by batch, in the padded
  layout, under the same rule, and then writes each client's row of the
  logit table (its server logits in padded row order).  The round's slots
  are the sampled clients themselves: no slot is a padding duplicate, so
  every slot is written back.

No trust hook runs in these JAX rounds: attacks, defenses and both DPs are
refused when the object is built, and so is ``frequency_of_the_test`` 0, on
which the JAX rounds divide by zero.  ``round_times`` and ``round_losses``
hold each round's seconds and loss.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ...core.sampling import client_sampling
from ...device import fp32_matmul
from ...ml.engine.train import get_variables, load_variables
from ...ml.trainer.cls_trainer import to_device
from ...utils.metrics import MetricsLogger
from ...utils.rng import VFL_INMESH_WEIGHT_SALT, seeded_generator
from ..sp.fedavg.fedavg_api import own_loop_setup
from ..sp.fedgkt.gkt_api import FedGKTAPI, _kl
from ..sp.split_nn.split_nn_api import SplitNNAPI

logger = logging.getLogger(__name__)


def _pad_clients(local_train, local_num, num_clients: int, batch_size: int,
                 device: torch.device):
    """Concatenate the client shards into one array pair on ``device`` and
    give each client a row of indices padded to ``padded_n`` (the padding
    repeats the client's first row; its count masks it out): the round
    simulator's ``_pack_data`` layout, standalone.  Returns ``(x_all, y_all,
    idx [num_clients, padded_n], counts, padded_n)``; inputs are stored
    fp32, as the JAX package stores them."""
    counts = np.array([local_num[i] for i in range(num_clients)], np.int64)
    padded_n = max(batch_size, -(-int(counts.max()) // batch_size) * batch_size)
    xs, ys = [], []
    idx = np.zeros((num_clients, padded_n), np.int64)
    cursor = 0
    for i in range(num_clients):
        xi, yi = local_train[i]
        n = len(yi)
        xs.append(np.asarray(xi, np.float32))
        ys.append(np.asarray(yi))
        if n > 0:
            idx[i, :n] = np.arange(cursor, cursor + n)
            idx[i, n:] = cursor
        cursor += n
    device = torch.device(device)
    return (torch.from_numpy(np.concatenate(xs, 0)).to(device),
            torch.from_numpy(np.concatenate(ys, 0)).to(device),
            torch.from_numpy(idx).to(device), counts, padded_n)


def _batch_mask(n: int, b: int, bs: int, device) -> torch.Tensor:
    """The real rows of batch ``b`` of a client of ``n`` rows padded after
    them: the first ``clamp(n - b * bs, 0, bs)`` rows."""
    return (torch.arange(bs, device=device) < n - b * bs).float()


def _masked_mean(per: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (per * mask).sum() / mask.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# Vertical FL
# ---------------------------------------------------------------------------
class VFLInMeshAPI:
    def __init__(self, args, device, dataset, model=None):
        self.args = args
        self.freq = own_loop_setup(args, type(self).__name__)
        self.device = torch.device(device)
        (_, _, (x_tr, y_tr), (x_te, y_te), *_rest, self.class_num) = dataset
        x_tr = np.asarray(x_tr, np.float32).reshape(len(y_tr), -1)
        x_te = np.asarray(x_te, np.float32).reshape(len(y_te), -1)
        y_tr, y_te = np.asarray(y_tr), np.asarray(y_te)
        if y_tr.ndim > 1:  # multi-hot -> the dominant concept
            y_tr, y_te = y_tr.argmax(-1), y_te.argmax(-1)
        self.parties = int(getattr(args, "vfl_party_num", 2))  # logical owners only
        self.x_tr, self.x_te = to_device(x_tr, self.device), to_device(x_te, self.device)
        self.y_tr = to_device(y_tr.astype(np.int64), self.device)
        self.y_te = to_device(y_te.astype(np.int64), self.device)
        seed = int(getattr(args, "random_seed", 0))
        self.w = (0.01 * torch.randn((x_tr.shape[1], self.class_num),
                                     generator=seeded_generator((seed, VFL_INMESH_WEIGHT_SALT)))
                  ).to(self.device)
        self.b = torch.zeros((self.class_num,), device=self.device)
        self.lr = float(getattr(args, "learning_rate", 0.1))
        self.metrics = MetricsLogger(args)
        self.round_times: List[float] = []
        self.round_losses: List[float] = []

    @torch.no_grad()
    def _step(self) -> torch.Tensor:
        """One full-batch step: the summed partial logits, the mean CE, and
        the guest's dL/dz = (softmax - onehot) / B back to the weights."""
        logp = F.log_softmax(self.x_tr @ self.w + self.b, dim=-1)
        loss = -logp.gather(1, self.y_tr[:, None]).mean()
        dz = (logp.exp() - F.one_hot(self.y_tr, self.class_num).float()) / self.y_tr.shape[0]
        self.w = self.w - self.lr * (self.x_tr.T @ dz)
        self.b = self.b - self.lr * dz.sum(dim=0)
        return loss

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
                    z = self.x_te @ self.w + self.b
                    acc = float((z.argmax(dim=1) == self.y_te).float().mean())
                last = {"round": r, "test_acc": round(acc, 4), "train_loss": round(loss, 4)}
                self.metrics.log(last)
        return last


# ---------------------------------------------------------------------------
# SplitNN
# ---------------------------------------------------------------------------
class SplitNNInMeshAPI(SplitNNAPI):
    def __init__(self, args, device, dataset, model=None):
        super().__init__(args, device, dataset, model)
        self.num_clients = int(args.client_num_in_total)
        (self.x_all, self.y_all, self.client_idx, self.counts, self.padded_n
         ) = _pad_clients(self.local_train, self.local_num, self.num_clients, self.bs,
                          self.device)
        self.y_all = self.y_all.long()

    def _train(self) -> Dict[str, Any]:
        rounds = int(self.args.comm_round)
        bs = self.bs
        last: Dict[str, Any] = {}
        for r in range(rounds):
            t0 = time.time()
            lsum = torch.zeros((), device=self.device)
            for cid in range(self.num_clients):  # the one relay chain
                n = int(self.counts[cid])
                x = self.x_all.index_select(0, self.client_idx[cid])
                y = self.y_all.index_select(0, self.client_idx[cid])
                for b in range(-(-n // bs)):  # the batches with a real row
                    mb = _batch_mask(n, b, bs, self.device)
                    loss = self._split_step(x[b * bs:(b + 1) * bs], y[b * bs:(b + 1) * bs], mb)
                    lsum += loss * float(min(n - b * bs, bs))
            self.round_losses.append(float(lsum) / max(float(self.counts.sum()), 1e-9))
            self.round_times.append(time.time() - t0)
            if r % self.freq == 0 or r == rounds - 1:
                last = self._evaluate(r)
        return last

    @torch.no_grad()
    def _evaluate(self, r: int) -> Dict[str, Any]:
        logits = self.back(self.front(self.x_te))
        acc = float((logits.argmax(dim=1) == self.y_te).float().mean())
        out = {"round": r, "test_acc": round(acc, 4),
               "train_loss": round(self.round_losses[-1], 4)}
        self.metrics.log(out)
        return out


# ---------------------------------------------------------------------------
# FedGKT
# ---------------------------------------------------------------------------
class GKTInMeshAPI(FedGKTAPI):
    def __init__(self, args, device, dataset, model=None):
        super().__init__(args, device, dataset, model)
        self.num_clients = int(args.client_num_in_total)
        (self.x_all, self.y_all, self.client_idx, self.counts, self.padded_n
         ) = _pad_clients(self.local_train, self.local_num, self.num_clients, self.bs,
                          self.device)
        self.y_all = self.y_all.long()
        self.n_batches = self.padded_n // self.bs

    def round_slots(self, round_idx: int) -> List[int]:
        """The round's slots: the sampled clients, each once."""
        return [int(c) for c in client_sampling(round_idx, self.num_clients,
                                                int(self.args.client_num_per_round))]

    def _client_phase(self, cid: int, epochs: int):
        """One client's edge training over its padded rows, then the transfer
        extraction over all of them: (features, logits, labels, mask)."""
        x = self.x_all.index_select(0, self.client_idx[cid])
        y = self.y_all.index_select(0, self.client_idx[cid])
        n, bs = int(self.counts[cid]), self.bs
        net = self.client_net
        load_variables(net, self.client_params.get(cid, self._proto_client_params))
        net.train()
        opt = torch.optim.SGD(net.parameters(), lr=self.lr, momentum=0.9)
        s_log = self.server_logits.get(cid)  # None: no KD before the first contact
        for i in range(self.n_batches * epochs):
            b = i % self.n_batches
            sl = slice(b * bs, (b + 1) * bs)
            mb = _batch_mask(n, b, bs, self.device)
            _, logits = net(x[sl])
            loss = _masked_mean(F.cross_entropy(logits, y[sl], reduction="none"), mb)
            if s_log is not None:
                loss = loss + self.alpha * _kl(s_log[sl], logits, self.temperature, mb)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()  # a batch with no real row still takes the momentum step
        self.client_params[cid] = get_variables(net)
        with torch.no_grad():
            feats, logits = net(x)
        return feats, logits, y, (torch.arange(self.padded_n, device=self.device) < n).float()

    def _server_phase(self, transfer) -> torch.Tensor:
        """The tower's epochs over the transfer set, slot by slot and batch by
        batch in the padded layout; returns the last batch's loss."""
        net, bs = self.server_net, self.bs
        net.train()
        opt = torch.optim.SGD(net.parameters(), lr=self.lr, momentum=0.9)
        loss = torch.zeros((), device=self.device)
        for _ in range(self.server_epochs):
            for feats, c_logits, y, mask in transfer.values():
                for b in range(self.n_batches):
                    sl = slice(b * bs, (b + 1) * bs)
                    logits = net(feats[sl])
                    loss = (_masked_mean(F.cross_entropy(logits, y[sl], reduction="none"),
                                         mask[sl])
                            + self.alpha * _kl(c_logits[sl], logits, self.temperature,
                                               mask[sl]))
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    opt.step()
        return loss.detach()

    def _train(self) -> Dict[str, Any]:
        comm_round = int(self.args.comm_round)
        epochs = int(getattr(self.args, "epochs", 1))
        last: Dict[str, Any] = {}
        for round_idx in range(comm_round):
            t0 = time.time()
            slots = self.round_slots(round_idx)
            transfer = {cid: self._client_phase(cid, epochs) for cid in slots}
            loss = self._server_phase(transfer)
            with torch.no_grad():  # each slot's row of the logit table, written back
                self.server_net.eval()
                for cid, (feats, _cl, _y, _m) in transfer.items():
                    self.server_logits[cid] = self.server_net(feats)
            self.round_losses.append(float(loss))
            self.round_times.append(time.time() - t0)
            self.metrics.log({"round": round_idx, "server_loss": self.round_losses[-1]})
            if round_idx % self.freq == 0 or round_idx == comm_round - 1:
                last = self._test_global(round_idx, slots[0])
        return last
