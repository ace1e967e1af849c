"""In-mesh decentralized (gossip) FL of the port (counterpart of
``fedml_tpu/simulation/xla/decentralized.py``): ``DecentralizedInMeshAPI``
and ``SpreadGNNInMeshAPI``, which ``SimulatorXLA`` builds for
``federated_optimizer`` ``decentralized_fl`` and ``spreadgnn``.

The JAX package compiles a serverless round into one XLA program over the
``client`` mesh axis: a ``lax.scan`` trains each device's node slots, an
``all_gather`` and one matmul with the mixing matrix's rows mix them, and a
``psum`` gives the consensus.  On one card the node models are one stacked
table (one ``[n_nodes, ...]`` tensor a leaf) and a round is:

* every node slot trains its own model on its data with the padded engine
  (``ml.engine.train.build_local_train``), one after another: the
  counterpart of the scan.  A node's shuffles are seeded from (seed, round,
  node), as the port's ``sp`` trainer seeds a client's, so the two twins
  agree bit for bit where their padded shapes agree;
* each mixed leaf is gossiped by one ``torch.tensordot`` with the
  ``[n_nodes, n_nodes]`` mixing matrix (the topology's row-normalized
  matrix), as the ``sp`` twin mixes its stack;
* the consensus evaluated is the mean over the nodes.

``SpreadGNNInMeshAPI`` keeps the task heads (``mtl_local_head_names``) out
of the mix, skips the consensus, and evaluates the per-node mean, each node
with its own head.  The table lives on one card: the JAX table's padding
of the node axis to a multiple of its devices has no counterpart here.

No trust hook runs in the JAX in-mesh round: attacks, defenses and both DPs
are refused here when they are on, as are the knobs the port has not
ported.  ``round_times`` holds each round's seconds.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List

import torch

from ...core.distributed.topology.topology_manager import SymmetricTopologyManager
from ...device import fp32_matmul
from ...ml.aggregator.aggregator_creator import create_server_aggregator
from ...ml.engine.train import build_local_train, init_variables
from ...ml.trainer.trainer_creator import loss_kind_for_dataset
from ...utils.metrics import MetricsLogger
from ..sp.fedavg.fedavg_api import active_hooks
from ..sp.spreadgnn.spreadgnn_api import _is_local_head, head_names_from, per_node_mean_eval
from .fed_sim import refuse_unported_knobs
from .split import _pad_clients

logger = logging.getLogger(__name__)


class DecentralizedInMeshAPI:
    _needs_consensus = True  # SpreadGNN's personalized eval reads none

    def _mix_leaf(self, name: str) -> bool:
        """Whether a parameter takes part in the gossip (SpreadGNN keeps its
        task heads node-local)."""
        return True

    def __init__(self, args, device, dataset, model=None):
        self.args = args
        (_tn, _ten, _tg, self.test_global, local_num, local_train, _lt,
         self.class_num) = dataset
        refuse_unported_knobs(args)
        on = active_hooks()
        if on:
            raise NotImplementedError(
                f"{type(self).__name__} runs no trust hook ({', '.join(sorted(on))} "
                "requested): its JAX twin skips them all silently")
        self.module = model
        self.device = torch.device(device)
        self.n_nodes = int(args.client_num_in_total)
        self.bs = int(getattr(args, "batch_size", 32))
        self.seed = int(getattr(args, "random_seed", 0))

        self.x_all, self.y_all, self._idx_rows, self._counts, self.padded_n = _pad_clients(
            local_train, local_num, self.n_nodes, self.bs, self.device)

        self.topo = SymmetricTopologyManager(
            self.n_nodes, int(getattr(args, "topology_neighbor_num", 2)), seed=self.seed)
        self.topo.generate_topology()
        self.mix = torch.as_tensor(self.topo.topology, dtype=torch.float32, device=self.device)

        # the stacked node table, every node from the same init
        proto = init_variables(model, self.device, seed=self.seed)
        self.table = {k: p.unsqueeze(0).repeat((self.n_nodes,) + (1,) * p.dim())
                      for k, p in proto.items()}
        self.consensus = proto

        loss_kind = loss_kind_for_dataset(str(getattr(args, "dataset", "")).lower())
        self._local_train = build_local_train(model, args, self.bs, self.padded_n,
                                              loss=loss_kind)
        self.aggregator = create_server_aggregator(model, args)
        self.metrics = MetricsLogger(args)
        self.eval_history: List[Dict[str, Any]] = []
        self.round_times: List[float] = []
        self.round_losses: List[float] = []

    def _round(self, round_idx: int) -> torch.Tensor:
        """Train every node, gossip the mixed leaves, and (for the consensus
        eval) average the nodes; returns the mean loss."""
        trained = {k: torch.empty_like(t) for k, t in self.table.items()}
        lsum = torch.zeros((), dtype=torch.float32, device=self.device)
        wsum = 0.0
        for node in range(self.n_nodes):
            n_i = int(self._counts[node])
            x = self.x_all.index_select(0, self._idx_rows[node])
            y = self.y_all.index_select(0, self._idx_rows[node])
            result = self._local_train({k: t[node] for k, t in self.table.items()}, x, y,
                                       n_i, seed=(self.seed, round_idx, node))
            lsum += result.loss * float(n_i)
            wsum += float(n_i)
            with torch.no_grad():
                for k, p in result.variables.items():
                    trained[k][node].copy_(p)
        with torch.no_grad():
            self.table = {k: torch.tensordot(self.mix, t, dims=([1], [0]))
                          if self._mix_leaf(k) else t for k, t in trained.items()}
            if self._needs_consensus:
                self.consensus = {k: t.mean(dim=0) for k, t in self.table.items()}
        return lsum / max(wsum, 1e-9)

    def train(self) -> Dict[str, Any]:
        """The run's rounds, with fp32 products in full fp32 (TF32 off)."""
        with fp32_matmul():
            return self._train()

    def _train(self) -> Dict[str, Any]:
        comm_round = int(self.args.comm_round)
        freq = int(getattr(self.args, "frequency_of_the_test", 5))
        last: Dict[str, Any] = {}
        for round_idx in range(comm_round):
            t0 = time.time()
            mean_loss = self._round(round_idx)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.round_times.append(time.time() - t0)
            self.round_losses.append(float(mean_loss))
            self.metrics.log({"round": round_idx, "train_loss": self.round_losses[-1]})
            if freq > 0 and (round_idx % freq == 0 or round_idx == comm_round - 1):
                last = self._test_global(round_idx)
        return last

    def node_params(self, node_id: int) -> Dict[str, torch.Tensor]:
        """One node's current model."""
        return {k: t[node_id] for k, t in self.table.items()}

    def _eval_stats(self, variables) -> Dict[str, float]:
        self.aggregator.set_model_params(variables)
        return self.aggregator.test(self.test_global, self.device, self.args)

    def _log_eval(self, round_idx: int, corr: float, loss: float, tot: float,
                  label: str) -> Dict[str, Any]:
        out = {"round": round_idx, "test_acc": round(corr / max(tot, 1.0), 4),
               "test_loss": round(loss / max(tot, 1.0), 4)}
        self.eval_history.append(out)
        self.metrics.log(out)
        logger.info("%s: %s", label, out)
        return out

    def _test_global(self, round_idx: int) -> Dict[str, Any]:
        stats = self._eval_stats(self.consensus)
        return self._log_eval(round_idx, stats["test_correct"], stats["test_loss"],
                              stats["test_total"], "decentralized in-mesh eval")


class SpreadGNNInMeshAPI(DecentralizedInMeshAPI):
    """SpreadGNN's round: the task heads (``mtl_local_head_names``, default
    ``readout``) never enter the mix and stay node-personalized; eval is the
    per-node mean, each node with its own head (the ``sp`` twin
    ``simulation/sp/spreadgnn/spreadgnn_api.py``)."""

    _needs_consensus = False

    def __init__(self, args, device, dataset, model=None):
        self.head_names = head_names_from(args)
        super().__init__(args, device, dataset, model)

    def _mix_leaf(self, name: str) -> bool:
        return not _is_local_head(name, self.head_names)

    def _test_global(self, round_idx: int) -> Dict[str, Any]:
        corr, loss, tot = per_node_mean_eval(
            self.aggregator, (self.node_params(i) for i in range(self.n_nodes)),
            self.test_global, self.device, self.args)
        return self._log_eval(round_idx, corr, loss, tot,
                              "spreadgnn in-mesh eval (per-node mean)")
