"""Hierarchical FL of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/hierarchical_fl/hier_api.py``): two-level
averaging.

The population is split into ``group_num`` groups, ``np.array_split`` of a
``RandomState(random_seed)`` permutation.  Each round each group draws
``client_num_per_round // group_num`` of its members (at least one) from
``RandomState(random_seed * 100003 + round * 131 + group)``, trains them
from the group's model and averages them into it by sample count; every
``group_comm_round`` rounds the group models are averaged into the global
model by the groups' total sample counts, the after-aggregation hooks run
on it, and every group starts again from it.  ``round_times`` holds each
round's seconds.

No update passes the before-stage or on-aggregation hooks and no client's
data is poisoned: model attacks, data poisoning and before- and
on-aggregation defenses are refused, as the JAX twin skips them.  The
after-aggregation defense and central DP run at each global average only.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np

from ....core.aggregate import weighted_mean
from ..fedavg.fedavg_api import (BEFORE_DEFENSE, DATA_POISONING, MODEL_ATTACK, ON_DEFENSE,
                                 FedAvgAPI)


class HierarchicalFLAPI(FedAvgAPI):
    SKIPPED_HOOKS = (MODEL_ATTACK, DATA_POISONING, BEFORE_DEFENSE, ON_DEFENSE)

    def __init__(self, args, device, dataset, model):
        super().__init__(args, device, dataset, model)
        self.group_num = int(getattr(args, "group_num", 2))
        self.group_comm_round = int(getattr(args, "group_comm_round", 2))
        rng = np.random.RandomState(int(getattr(args, "random_seed", 0)))
        ids = rng.permutation(int(args.client_num_in_total))
        self.groups = np.array_split(ids, self.group_num)
        # each group's current model starts at the global one
        self.group_models: List[Any] = [self.w_global for _ in range(self.group_num)]
        self.chosen: List[List[List[int]]] = []  # [round][group] -> the clients trained

    def _train(self) -> Dict[str, Any]:
        comm_round = int(self.args.comm_round)
        per_group = max(1, int(self.args.client_num_per_round) // self.group_num)
        seed = int(getattr(self.args, "random_seed", 0))
        slot = self.client_list[0]
        last: Dict[str, Any] = {}
        for round_idx in range(comm_round):
            t0 = time.time()
            self.trainer.round_idx = round_idx  # the round's seed of the shuffles
            self.chosen.append([])
            for g, members in enumerate(self.groups):
                rng = np.random.RandomState(seed * 100003 + round_idx * 131 + g)
                chosen = rng.choice(members, min(per_group, len(members)), replace=False)
                self.chosen[-1].append([int(c) for c in chosen])
                w_locals: List[Tuple[float, Any]] = []
                for cid in self.chosen[-1][-1]:
                    slot.update_local_dataset(
                        cid,
                        self.train_data_local_dict[cid],
                        self.test_data_local_dict[cid],
                        self.train_data_local_num_dict[cid],
                    )
                    w = self._train_client(slot, self.group_models[g])
                    w_locals.append((float(slot.local_sample_number), w))
                self.group_models[g] = weighted_mean(w_locals)
            if (round_idx + 1) % self.group_comm_round == 0:
                sizes = [float(sum(self.train_data_local_num_dict[int(c)] for c in m))
                         for m in self.groups]
                self.w_global = weighted_mean(list(zip(sizes, self.group_models)))
                self.w_global = self.aggregator.on_after_aggregation(self.w_global)
                self.aggregator.set_model_params(self.w_global)
                self.group_models = [self.w_global for _ in range(self.group_num)]
            self._sync()
            self.round_times.append(time.time() - t0)
            if self._eval_due(round_idx, comm_round):
                last = self._test_global(round_idx)
        return last
