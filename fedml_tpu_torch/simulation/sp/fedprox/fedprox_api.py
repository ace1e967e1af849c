"""FedProx of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/fedprox/fedprox_api.py``): FedAvg with the
proximal term mu/2 * ||w - w_global||^2 in the client loss.  That term is
the engine's grad hook g + mu*(w - anchor), which ``resolve_grad_hook``
installs from ``args.proximal_mu`` (``Arguments.validate`` sets FedProx's
default mu when none is given), so the class adds nothing to FedAvg."""

from __future__ import annotations

from ..fedavg.fedavg_api import FedAvgAPI


class FedProxAPI(FedAvgAPI):
    pass
