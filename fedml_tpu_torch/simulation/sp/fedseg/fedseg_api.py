"""FedSeg of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/fedseg/fedseg_api.py``, ``FedSegAPI``): federated
semantic segmentation with a loop of its own.

Each round samples its clients by ``core.sampling.client_sampling`` and
trains them one after another from the global model: a fresh SGD with
momentum 0.9 at ``learning_rate`` a client (``client_optimizer`` is not
read, as in the JAX twin), ``epochs`` passes over the client's data in
order, in full batches only (a trailing partial batch is dropped), each
step on the mean per-pixel CE of the whole batch.  The server takes the
sample-weighted mean of the clients' models (``weighted_mean``).  The eval,
at ``round_idx % frequency_of_the_test == 0`` and after the last round, runs
the global test set in batches of 64: pixel accuracy and the dataset-level
mIoU from the summed per-class counts, each rounded to 4 decimals.

A segmentation module passed in is kept ([B, H, W, C] -> [B, H, W,
classes]); a ``UNet`` is built only when none is given.  The module runs in
eval mode throughout, as the JAX twin applies it with ``train=False``.  The
JAX twin runs none of the trust hooks and ignores their knobs; this one
refuses each (the table is in ``simulation/sp/__init__.py``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ....core.aggregate import weighted_mean
from ....core.sampling import client_sampling
from ....device import fp32_matmul
from ....ml.engine.train import _ce, get_variables, init_variables, load_variables
from ....ml.trainer.cls_trainer import to_device
from ....ml.trainer.seg_trainer import EVAL_BATCH, dataset_miou
from ....models.unet import UNet, iou_counts
from ....utils.metrics import MetricsLogger
from ..fedavg.fedavg_api import own_loop_setup

logger = logging.getLogger(__name__)


class FedSegAPI:
    def __init__(self, args, device, dataset, model=None):
        self.args = args
        self.device = torch.device(device)
        (
            _tn, _ten, _tg, self.test_global, self.local_num, self.local_train, _lt,
            self.class_num,
        ) = dataset
        self.freq = own_loop_setup(args, "FedSegAPI")
        self.bs = int(getattr(args, "batch_size", 8))
        self.lr = float(getattr(args, "learning_rate", 0.01))
        self.net = model if isinstance(model, nn.Module) else UNet(self.class_num, device="meta")
        self.w_global = init_variables(self.net, self.device,
                                       seed=int(getattr(args, "random_seed", 0)))
        self.metrics = MetricsLogger(args)
        self.eval_history: List[Dict[str, Any]] = []
        self.round_times: List[float] = []

    def _local_train(self, cid: int, epochs: int) -> Dict[str, torch.Tensor]:
        x, masks = self.local_train[cid]
        load_variables(self.net, self.w_global)
        self.net.eval()
        opt = torch.optim.SGD(self.net.parameters(), lr=self.lr, momentum=0.9)
        xs, ms = to_device(x, self.device), to_device(masks, self.device).long()
        for _ in range(epochs):
            for s in range(0, len(masks) - self.bs + 1, self.bs):
                loss = _ce(self.net(xs[s:s + self.bs]), ms[s:s + self.bs]).mean()
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        return get_variables(self.net)

    def train(self) -> Dict[str, Any]:
        with fp32_matmul():
            return self._train()

    def _train(self) -> Dict[str, Any]:
        comm_round = int(self.args.comm_round)
        epochs = int(getattr(self.args, "epochs", 1))
        last: Dict[str, Any] = {}
        for round_idx in range(comm_round):
            t0 = time.time()
            sampled = client_sampling(round_idx, int(self.args.client_num_in_total),
                                      int(self.args.client_num_per_round))
            locals_: List[Tuple[float, Any]] = [
                (float(self.local_num[int(cid)]), self._local_train(int(cid), epochs))
                for cid in sampled]
            self.w_global = weighted_mean(locals_)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.round_times.append(time.time() - t0)
            self.metrics.log({"round": round_idx})
            if round_idx % self.freq == 0 or round_idx == comm_round - 1:
                last = self._test_global(round_idx)
        return last

    @torch.no_grad()
    def _test_global(self, round_idx: int) -> Dict[str, Any]:
        x, masks = self.test_global
        load_variables(self.net, self.w_global)
        self.net.eval()
        inter = union = 0
        correct = torch.zeros((), device=self.device)
        for s in range(0, len(masks), EVAL_BATCH):
            logits = self.net(to_device(x[s:s + EVAL_BATCH], self.device)).float()
            m = to_device(masks[s:s + EVAL_BATCH], self.device).long()
            i, u = iou_counts(logits, m, self.class_num)
            inter, union = inter + i, union + u
            correct += (logits.argmax(dim=-1) == m).sum()
        total = int(np.asarray(masks).size)
        out = {
            "round": round_idx,
            "test_acc": round(float(correct) / max(total, 1), 4),  # pixel accuracy
            "test_miou": round(dataset_miou(inter.cpu().numpy(), union.cpu().numpy()), 4),
        }
        self.eval_history.append(out)
        self.metrics.log(out)
        logger.info("fedseg eval: %s", out)
        return out
