"""Asynchronous FedAvg of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/async_fedavg/async_fedavg_api.py``).

An event-driven simulation in one process: each client has a simulated
duration, ``0.5 + RandomState(random_seed).exponential(1, n)``; the first
``client_num_per_round`` clients are dispatched at version 0, and a heap of
``(finish time, seq, client, version at dispatch)`` orders their reports.
The server applies each arriving update at once with staleness-discounted
mixing ``w <- (1-a)*w + a*w_i``, ``a = alpha / (1 + staleness)^beta``, runs
the after-aggregation hooks on the result and re-dispatches the client on
the fresh model.  ``comm_round`` counts applied updates; the trainer's
round is the number applied so far.  ``round_times`` holds each update's
seconds.

The updates never pass the before-stage or on-aggregation hooks, and no
client's data is poisoned: model attacks, data poisoning and before- and
on-aggregation defenses are refused, as the JAX twin skips them.
"""

from __future__ import annotations

import heapq
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from ..fedavg.fedavg_api import (BEFORE_DEFENSE, DATA_POISONING, MODEL_ATTACK, ON_DEFENSE,
                                 FedAvgAPI)


class AsyncFedAvgAPI(FedAvgAPI):
    SKIPPED_HOOKS = (MODEL_ATTACK, DATA_POISONING, BEFORE_DEFENSE, ON_DEFENSE)

    def __init__(self, args, device, dataset, model):
        super().__init__(args, device, dataset, model)
        self.alpha = float(getattr(args, "async_alpha", 0.6))
        self.beta = float(getattr(args, "async_beta", 0.5))
        rng = np.random.RandomState(int(getattr(args, "random_seed", 0)))
        # heterogeneous simulated round durations per client
        self.durations = 0.5 + rng.exponential(1.0, size=int(args.client_num_in_total))

    def _train(self) -> Dict[str, Any]:
        total_updates = int(self.args.comm_round)
        n_concurrent = int(self.args.client_num_per_round)
        sampled = list(range(min(n_concurrent, int(self.args.client_num_in_total))))

        # priority queue of (finish_time, seq, client_idx, model_version_at_dispatch)
        events: List[Tuple[float, int, int, int]] = []
        seq = 0
        version = 0
        for cid in sampled:
            heapq.heappush(events, (self.durations[cid], seq, cid, version))
            seq += 1

        slot = self.client_list[0]
        applied = 0
        last: Dict[str, Any] = {}
        while applied < total_updates:
            t0 = time.time()
            t, _, cid, v_dispatch = heapq.heappop(events)
            self.trainer.round_idx = applied  # each update's own shuffle seed
            slot.update_local_dataset(
                cid,
                self.train_data_local_dict[cid],
                self.test_data_local_dict[cid],
                self.train_data_local_num_dict[cid],
            )
            w_i = self._train_client(slot, self.w_global)
            staleness = version - v_dispatch
            a = self.alpha / ((1.0 + staleness) ** self.beta)
            self.w_global = {k: (1.0 - a) * g + a * w_i[k] for k, g in self.w_global.items()}
            self.w_global = self.aggregator.on_after_aggregation(self.w_global)
            self.aggregator.set_model_params(self.w_global)
            self._sync()
            version += 1
            applied += 1
            self.round_times.append(time.time() - t0)
            self.metrics.log({"update": applied, "client": cid, "staleness": staleness,
                              "mix": round(a, 4)})
            heapq.heappush(events, (t + self.durations[cid], seq, cid, version))
            seq += 1
            if applied % self.freq == 0 or applied == total_updates:
                last = self._test_global(applied)
        return last
