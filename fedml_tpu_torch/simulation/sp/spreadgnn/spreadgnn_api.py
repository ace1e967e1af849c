"""SpreadGNN of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/spreadgnn/spreadgnn_api.py``): serverless
decentralized multi-task GNN FL.

Nodes train on the masked multi-task BCE (engine loss ``mtl_bce``) and
gossip over the topology's mixing matrix as ``DecentralizedFLAPI`` does, but
only the shared encoder is mixed: the task heads (``mtl_local_head_names``,
default ``readout``) stay node-local, each tuned to its node's observed
tasks.  Eval is the mean over the nodes, each with its own head.  The trust
hooks it refuses are the decentralized member's (``SKIPPED_HOOKS``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterable, Tuple

import torch

from ..decentralized.decentralized_api import DecentralizedFLAPI

logger = logging.getLogger(__name__)


def _is_local_head(name: str, head_names: Tuple[str, ...]) -> bool:
    """One head rule for both backends (the in-mesh SpreadGNN imports it): a
    parameter is a personalized head iff one segment of its dotted name is
    a head name exactly (``readout`` does not match ``readout2``)."""
    segments = set(name.split("."))
    return any(h in segments for h in head_names)


def head_names_from(args) -> Tuple[str, ...]:
    """``mtl_local_head_names`` as a tuple (default: ``readout``)."""
    heads = getattr(args, "mtl_local_head_names", None) or ("readout",)
    if isinstance(heads, str):
        heads = (heads,)
    return tuple(heads)


def per_node_mean_eval(aggregator, nodes: Iterable[Any], test_data, device,
                       args) -> Tuple[float, float, float]:
    """SpreadGNN's eval on both backends: each node's model, its own head
    in it, on the global test set; returns the summed (correct, loss, total)."""
    corr = loss = tot = 0.0
    for m in nodes:
        aggregator.set_model_params(m)
        stats = aggregator.test(test_data, device, args)
        corr += stats["test_correct"]
        loss += stats["test_loss"]
        tot += stats["test_total"]
    return corr, loss, tot


class SpreadGNNAPI(DecentralizedFLAPI):
    def __init__(self, args, device, dataset, model):
        super().__init__(args, device, dataset, model)
        self.head_names = head_names_from(args)

    def _gossip(self, stacked):
        # the personalized heads pass through, never averaged
        return {k: x if _is_local_head(k, self.head_names)
                else torch.tensordot(self.mix, x, dims=([1], [0]))
                for k, x in stacked.items()}

    def _test_global(self, round_idx: int) -> Dict[str, Any]:
        """The per-node mean, each node with its own head."""
        corr, loss, tot = per_node_mean_eval(self.aggregator, self.node_models,
                                             self.test_data_global, self.device, self.args)
        out = {
            "round": round_idx,
            "test_acc": round(corr / max(tot, 1.0), 4),
            "test_loss": round(loss / max(tot, 1.0), 4),
        }
        self.metrics.log(out)
        logger.info("eval (per-node mean): %s", out)
        return out
