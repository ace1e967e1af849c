"""Single-process algorithm registry of the port (counterpart of
``fedml_tpu/simulation/sp/__init__.py``).  FedAvg is ported; every other
optimizer raises ``NotImplementedError`` naming the ROADMAP.md item that
ports it."""

from __future__ import annotations

_ZOO_ITEM = "ROADMAP.md queue A, item 2: the rest of the sp zoo"
_MODEL_ITEM = "ROADMAP.md queue A, item 4: model zoo and trainers"
# lower-cased optimizer -> the item that ports its sp API
_UNPORTED = {
    **dict.fromkeys(("fedopt", "fedprox", "fednova", "fedsgd", "scaffold", "feddyn",
                     "hierarchicalfl", "decentralized_fl", "turbo_aggregate",
                     "async_fedavg"), _ZOO_ITEM),
    # these come with their models
    **dict.fromkeys(("spreadgnn", "classical_vertical", "split_nn", "fedgan", "fedgkt",
                     "fednas", "fedseg"), _MODEL_ITEM),
}


def create_sp_algorithm(optimizer: str, args, device, dataset, model):
    opt = optimizer.lower()
    if str(getattr(args, "fl_mode", "sync") or "sync").lower() == "async":
        if opt != "fedavg":
            raise ValueError(
                f"fl_mode=async supports federated_optimizer 'fedavg' only "
                f"in the sp simulator (got {optimizer!r})")
        raise NotImplementedError(
            f"fl_mode=async (FedBuffAPI) is not ported to the sp simulator yet ({_ZOO_ITEM})")
    if opt == "fedavg":
        from .fedavg.fedavg_api import FedAvgAPI

        return FedAvgAPI(args, device, dataset, model)
    if opt in _UNPORTED:
        raise NotImplementedError(
            f"federated_optimizer {optimizer!r} is not ported to the sp simulator yet "
            f"({_UNPORTED[opt]})")
    raise ValueError(f"unknown federated_optimizer {optimizer!r}")
