"""Round strategies of the port's simulator (counterpart of
``fedml_tpu/simulation/xla/algorithms.py``).

An algorithm is a strategy the round calls into: a server update applied
to the weighted sum of the client variables.  FedAvg is ported; every other optimizer raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Variables = Dict[str, torch.Tensor]


def _weighted_avg(acc: Variables, wsum: float, like: Variables) -> Variables:
    """acc is the fp32 weighted SUM of client variables; divide and restore
    each parameter's dtype."""
    return {k: (a / max(float(wsum), 1e-9)).to(like[k].dtype) for k, a in acc.items()}


class InMeshAlgorithm:
    """FedAvg, and the contract every strategy implements: the simulator
    accumulates ``acc += n_i * variables_i`` (fp32) and ``wsum += n_i`` over the
    sampled clients, then calls ``server_update``.  The JAX package's per-client
    hooks (contributions, client state, grad hooks) arrive with the algorithms
    that use them."""

    def __init__(self, args):
        self.args = args

    def init_server_state(self, variables: Variables) -> Any:
        return ()

    def server_update(self, acc: Variables, wsum: float, variables: Variables,
                      server_state) -> Tuple[Variables, Any]:
        return _weighted_avg(acc, wsum, variables), server_state


class FedAvgInMesh(InMeshAlgorithm):
    """Sample-weighted averaging of the clients' local models."""


_LATER = {
    "fedprox": "FedProx", "fedopt": "FedOpt", "fednova": "FedNova", "scaffold": "SCAFFOLD",
    "feddyn": "FedDyn", "fedsgd": "FedSGD", "async_fedavg": "Async_FedAvg",
    "fedbuff": "FedBuff",
}


def create_inmesh_algorithm(args) -> InMeshAlgorithm:
    opt = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
    if opt == "fedavg":
        return FedAvgInMesh(args)
    raise NotImplementedError(
        f"federated_optimizer {_LATER.get(opt, opt)!r} is not ported yet "
        "(ROADMAP.md queue A, item 12: other in-mesh algorithms)")
