"""In-mesh FedGAN and FedNAS of the port (counterpart of
``fedml_tpu/simulation/xla/gan_nas.py``): ``GANInMeshAPI`` and
``NASInMeshAPI``, which ``SimulatorXLA`` builds for ``federated_optimizer``
``fedgan`` and ``fednas``.

The JAX package compiles a round into one XLA program over the ``client``
mesh axis: the clients' data packed once by ``_pad_clients``, the sampled
clients balanced over the devices by ``core/schedule`` (``_schedule_round``),
a ``lax.scan`` over each device's slots, a weighted ``psum``.  On one card a
round is the ``sp`` twin's round over the scheduled clients in slot order
(a slot of weight 0 adds nothing and is skipped), so each class here is its
``sp`` twin with only the round's client list changed:

* ``GANInMeshAPI`` (``sp/fedgan``'s ``FedGanAPI``): this twin's own window
  rule: step i's real window starts at ``(i * batch_size) mod max(min(n,
  rows) - batch_size, 1)`` over the client's padded index row (``rows`` its
  length; a client smaller than a batch reads the row's padding), weighted
  by the client's count ``n`` (not a tiled length).  A replacement latent
  source is told each slot's place in the round.
* ``NASInMeshAPI`` (``sp/fednas``'s ``FedNASAPI``): each client searches on
  its real rows: the JAX program's steps past a client's full batches leave
  (w, alpha) and both optimizers untouched, so skipping them is the same,
  adam's step count included.  It evaluates only when
  ``frequency_of_the_test`` > 0, where the ``sp`` twin refuses 0.

No trust hook runs in the JAX in-mesh rounds: attacks, defenses and both
DPs are refused here when they are on, as are the knobs the port has not
ported.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from ...core.sampling import client_sampling
from ..sp.fedavg.fedavg_api import own_loop_setup
from ..sp.fedgan.fedgan_api import FedGanAPI
from ..sp.fednas.fednas_api import FedNASAPI
from .split import _pad_clients


def _schedule_round(sampled: np.ndarray, counts_all: np.ndarray, n_dev: int = 1):
    """The sampled clients balanced over ``n_dev`` devices by the shared
    ``core/schedule`` scheduler; dummy slots get count 0.  Returns (ids
    [n_dev * slots], counts [n_dev * slots]), each device's slots
    contiguous."""
    from ...core.schedule import SeqTrainScheduler

    sizes = [int(counts_all[int(c)]) for c in sampled]
    ids2d, mask2d, _ = SeqTrainScheduler(n_dev).schedule(sampled, sizes)
    ids = ids2d.reshape(-1).astype(np.int64)
    cnt = np.where(mask2d.reshape(-1) > 0, counts_all[ids], 0).astype(np.int64)
    return ids, cnt


def _scheduled(args, round_idx: int, local_num) -> List[Tuple[int, int, int]]:
    """(slot, client, count) of the round's scheduled clients of count > 0."""
    total = int(args.client_num_in_total)
    counts = np.array([local_num[i] for i in range(total)], np.int64)
    sampled = client_sampling(round_idx, total, int(args.client_num_per_round))
    ids, cnt = _schedule_round(sampled, counts)
    return [(slot, int(c), int(n)) for slot, (c, n) in enumerate(zip(ids, cnt)) if n > 0]


class GANInMeshAPI(FedGanAPI):
    def __init__(self, args, device, dataset, model=None, latents=None):
        super().__init__(args, device, dataset, model, latents)
        x_all, _y, self.idx, _counts, self.padded_n = _pad_clients(
            self.local_train, self.local_num, int(args.client_num_in_total), self.bs,
            self.device)
        if x_all.dim() == 3:  # channel axis and tanh range, once
            x_all = x_all[..., None]
        self.x_all = x_all * 2.0 - 1.0

    def _round_clients(self, round_idx: int) -> Iterator[Tuple[int, int, torch.Tensor, int, float]]:
        for slot, cid, n in _scheduled(self.args, round_idx, self.local_num):
            yield (slot, cid, self.x_all.index_select(0, self.idx[cid]),
                   max(min(n, self.padded_n) - self.bs, 1), float(n))


class NASInMeshAPI(FedNASAPI):
    def _checks(self, args) -> int:
        own_loop_setup(args, type(self).__name__, frequency=False)
        return int(getattr(args, "frequency_of_the_test", 5))  # <= 0: no eval

    def _round_clients(self, round_idx: int) -> List[Tuple[int, float]]:
        return [(cid, float(n)) for _slot, cid, n in
                _scheduled(self.args, round_idx, self.local_num)]
