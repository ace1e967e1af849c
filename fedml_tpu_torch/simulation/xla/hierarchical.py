"""In-mesh hierarchical FL of the port (counterpart of
``fedml_tpu/simulation/xla/hierarchical.py``): ``HierarchicalInMeshAPI``,
which ``SimulatorXLA`` builds for ``federated_optimizer`` ``hierarchicalfl``,
and ``PaddedClients``, what it and the in-mesh Turbo-Aggregate round
(``turbo.py``) change in their ``sp`` twins.

The JAX package compiles the two-level round (client -> group -> global)
into one XLA program over the ``client`` mesh axis: each slot trains from
its group's model in a ``[G, ...]`` group stack, and a one-hot(group)
contraction with a ``psum`` gives the group means.  On one card that is the
``sp`` twin's round (``HierarchicalFLAPI``: its groups and draws, the
count-weighted group means, the size-weighted global sync with its
after-aggregation hooks) with each client trained as the JAX round trains
it: by the padded engine (``ml.engine.train.build_local_train``) on its rows
padded to the largest client's batches (``_pad_clients``, ``padded_n``), its
shuffles seeded from (seed, round, client).  The ``sp`` trainer pads to a
power-of-two multiple of the batch instead, so the two shuffle differently
wherever the lengths differ.  The JAX slot order (``core/schedule``) would
change only the order of the group sums, and is not kept.

The JAX rounds run only the after-aggregation hooks (the defender's
post-processing and central DP): attacks, the before- and on-aggregation
defenses and local DP are refused when the object is built.
``frequency_of_the_test`` 0 runs without an eval, as in JAX.
``round_losses`` holds each round's count-weighted mean training loss and
``eval_history`` each eval.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ...ml.engine.train import build_local_train
from ...ml.trainer.trainer_creator import loss_kind_for_dataset
from ..sp.fedavg.fedavg_api import (BEFORE_DEFENSE, DATA_POISONING, LOCAL_DP, MODEL_ATTACK,
                                    ON_DEFENSE)
from ..sp.hierarchical_fl.hier_api import HierarchicalFLAPI
from .split import _pad_clients


class PaddedClients:
    """Mixed in ahead of an ``FedAvgAPI`` member: its clients trained on
    their rows padded to ``padded_n``, the rounds' losses and evals kept,
    only the after-aggregation hooks run."""

    SKIPPED_HOOKS = (MODEL_ATTACK, DATA_POISONING, BEFORE_DEFENSE, ON_DEFENSE, LOCAL_DP)

    def __init__(self, args, device, dataset, model):
        super().__init__(args, device, dataset, model)
        self.seed = int(getattr(args, "random_seed", 0))
        bs = int(getattr(args, "batch_size", 32))
        self.x_all, self.y_all, self.idx, _counts, self.padded_n = _pad_clients(
            self.train_data_local_dict, self.train_data_local_num_dict,
            int(args.client_num_in_total), bs, self.device)
        self._local_train = build_local_train(
            model, args, bs, self.padded_n,
            loss=loss_kind_for_dataset(str(getattr(args, "dataset", "")).lower()))
        self._losses: Dict[int, List[Any]] = {}  # round -> [sum of n * loss, sum of n]
        self.eval_history: List[Dict[str, Any]] = []

    def _frequency(self, args) -> int:
        return int(getattr(args, "frequency_of_the_test", 5))  # <= 0: no eval

    def _train_client(self, client, w_start) -> Any:
        cid, n = int(client.client_idx), int(client.local_sample_number)
        round_idx = int(self.trainer.round_idx)
        result = self._local_train(w_start, self.x_all.index_select(0, self.idx[cid]),
                                   self.y_all.index_select(0, self.idx[cid]), n,
                                   seed=(self.seed, round_idx, cid))
        acc = self._losses.setdefault(round_idx, [0.0, 0])
        acc[0], acc[1] = acc[0] + result.loss.detach() * n, acc[1] + n
        return result.variables

    @property
    def round_losses(self) -> List[float]:
        return [float(s) / max(n, 1) for _r, (s, n) in sorted(self._losses.items())]

    def _test_global(self, round_idx: int) -> Dict[str, Any]:
        out = super()._test_global(round_idx)
        self.eval_history.append(out)
        return out


class HierarchicalInMeshAPI(PaddedClients, HierarchicalFLAPI):
    pass
