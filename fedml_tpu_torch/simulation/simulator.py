"""Simulator dispatch of the port (counterpart of
``fedml_tpu/simulation/simulator.py``): backend ``sp`` (the default) runs the
single-process round loop (``simulation/sp``), clients one after another
through their trainer and the server aggregator's hooks; ``XLA`` (and
``MPI`` / ``NCCL``, as in the JAX package) runs the round simulator on one
card, or, for ``decentralized_fl`` and ``spreadgnn``, the in-mesh gossip
round (``simulation/xla/decentralized.py``), for ``fedgan`` and ``fednas``
the in-mesh FedGAN and FedNAS rounds (``simulation/xla/gan_nas.py``).  The
round simulator refuses the other optimizers that have a program of their
own in the JAX package (``create_inmesh_algorithm``: ROADMAP.md queue A,
item 5: the other simulators)."""

from __future__ import annotations

from ..constants import (
    FEDML_SIMULATION_TYPE_MPI,
    FEDML_SIMULATION_TYPE_NCCL,
    FEDML_SIMULATION_TYPE_SP,
    FEDML_SIMULATION_TYPE_XLA,
)


class SimulatorSingleProcess:
    def __init__(self, args, device, dataset, model):
        opt = str(getattr(args, "federated_optimizer", "FedAvg"))
        from .sp import create_sp_algorithm

        self.fl_trainer = create_sp_algorithm(opt, args, device, dataset, model)

    def run(self):
        return self.fl_trainer.train()


class SimulatorXLA:
    def __init__(self, args, device, dataset, model):
        opt = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
        if opt == "decentralized_fl":
            from .xla.decentralized import DecentralizedInMeshAPI

            self.sim = DecentralizedInMeshAPI(args, device, dataset, model)
        elif opt == "spreadgnn":
            from .xla.decentralized import SpreadGNNInMeshAPI

            self.sim = SpreadGNNInMeshAPI(args, device, dataset, model)
        elif opt == "fedgan":
            from .xla.gan_nas import GANInMeshAPI

            self.sim = GANInMeshAPI(args, device, dataset, model)
        elif opt == "fednas":
            from .xla.gan_nas import NASInMeshAPI

            self.sim = NASInMeshAPI(args, device, dataset, model)
        else:
            from .xla.fed_sim import XLASimulator

            self.sim = XLASimulator(args, dataset, model, device)

    def run(self):
        return self.sim.train()


def create_simulator(args, device, dataset, model):
    backend = str(getattr(args, "backend", FEDML_SIMULATION_TYPE_SP))
    if backend == FEDML_SIMULATION_TYPE_SP:
        return SimulatorSingleProcess(args, device, dataset, model)
    if backend in (FEDML_SIMULATION_TYPE_XLA, FEDML_SIMULATION_TYPE_MPI,
                   FEDML_SIMULATION_TYPE_NCCL):
        return SimulatorXLA(args, device, dataset, model)
    if backend == "MPI_PROC":
        raise NotImplementedError(
            f"simulation backend {backend!r} is not ported yet "
            "(ROADMAP.md queue A, item 5: the other simulators)")
    raise ValueError(f"unknown simulation backend {backend!r}")
