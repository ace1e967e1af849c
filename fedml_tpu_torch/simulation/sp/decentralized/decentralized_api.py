"""Decentralized (gossip) FL of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/decentralized/decentralized_api.py``).

No server: each round every one of the ``client_num_in_total`` nodes trains
from its own model (in slot 0), then mixes with its neighbors by the row-
normalized mixing matrix of a ``SymmetricTopologyManager``
(``topology_neighbor_num`` neighbors, seeded ``random_seed``).  The models
are stacked on a leading axis and the gossip is one ``torch.tensordot`` of
the matrix with each stacked leaf, a plain product, as the JAX package
leaves it to XLA.  The consensus model evaluated is the mean of the mixed
node models.  ``round_times`` holds each round's seconds.

No server hook runs on this path: model attacks, data poisoning, every
defense and central DP are refused, as the JAX twin skips them.  Local DP
runs in each node's trainer.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from ....core.aggregate import tree_stack, tree_unstack
from ....core.distributed.topology.topology_manager import SymmetricTopologyManager
from ..fedavg.fedavg_api import (AFTER_DEFENSE, BEFORE_DEFENSE, CENTRAL_DP, DATA_POISONING,
                                 MODEL_ATTACK, ON_DEFENSE, FedAvgAPI)


class DecentralizedFLAPI(FedAvgAPI):
    SKIPPED_HOOKS = (MODEL_ATTACK, DATA_POISONING, BEFORE_DEFENSE, ON_DEFENSE, AFTER_DEFENSE,
                     CENTRAL_DP)

    def __init__(self, args, device, dataset, model):
        super().__init__(args, device, dataset, model)
        n = int(args.client_num_in_total)
        self.topo = SymmetricTopologyManager(
            n, int(getattr(args, "topology_neighbor_num", 2)),
            seed=int(getattr(args, "random_seed", 0)),
        )
        self.topo.generate_topology()
        self.mix = torch.as_tensor(self.topo.topology, dtype=torch.float32,
                                   device=self.device)  # [n, n]
        self.node_models: List[Any] = [self.w_global for _ in range(n)]

    def _gossip(self, stacked):
        # each stacked leaf [n, ...] -> mix @ leaf over the node axis
        return {k: torch.tensordot(self.mix, x, dims=([1], [0])) for k, x in stacked.items()}

    def _train(self) -> Dict[str, Any]:
        comm_round = int(self.args.comm_round)
        n = int(self.args.client_num_in_total)
        slot = self.client_list[0]
        last: Dict[str, Any] = {}
        for round_idx in range(comm_round):
            t0 = time.time()
            self.trainer.round_idx = round_idx  # the round's seed of the shuffles
            trained: List[Any] = []
            for cid in range(n):
                slot.update_local_dataset(
                    cid,
                    self.train_data_local_dict[cid],
                    self.test_data_local_dict[cid],
                    self.train_data_local_num_dict[cid],
                )
                trained.append(self._train_client(slot, self.node_models[cid]))
            mixed = self._gossip(tree_stack(trained))
            self.node_models = tree_unstack(mixed, n)
            # the consensus model (plain mean) for evaluation
            self.w_global = {k: x.mean(dim=0) for k, x in mixed.items()}
            self.aggregator.set_model_params(self.w_global)
            self._sync()
            self.round_times.append(time.time() - t0)
            if round_idx % self.freq == 0 or round_idx == comm_round - 1:
                last = self._test_global(round_idx)
        return last
