"""Simulator dispatch of the port (counterpart of
``fedml_tpu/simulation/simulator.py``): backend ``sp`` (the default) runs the
single-process round loop (``simulation/sp``), clients one after another
through their trainer and the server aggregator's hooks; ``XLA`` (and
``MPI`` / ``NCCL``, as in the JAX package) runs the round simulator on one
card, or, for the optimizers whose JAX twin is a program of its own, that
program's port: ``classical_vertical``, ``split_nn`` and ``fedgkt``
(``simulation/xla/split.py``), ``fedgan`` and ``fednas``
(``simulation/xla/gan_nas.py``), ``decentralized_fl`` and ``spreadgnn``
(``simulation/xla/decentralized.py``), ``turbo_aggregate``
(``simulation/xla/turbo.py``) and ``hierarchicalfl``
(``simulation/xla/hierarchical.py``).  ``MPI_PROC``, the process-real rank
plane, is not ported (ROADMAP.md queue A, item 5: the other simulators)."""

from __future__ import annotations

import importlib

from ..constants import (
    FEDML_SIMULATION_TYPE_MPI,
    FEDML_SIMULATION_TYPE_NCCL,
    FEDML_SIMULATION_TYPE_SP,
    FEDML_SIMULATION_TYPE_XLA,
)


# lower-cased optimizer -> (module under simulation/xla, class): the members
# whose JAX twin is an in-mesh program of its own (JAX's SimulatorXLA)
_PROGRAMS = {
    "classical_vertical": ("split", "VFLInMeshAPI"),
    "split_nn": ("split", "SplitNNInMeshAPI"),
    "fedgkt": ("split", "GKTInMeshAPI"),
    "fedgan": ("gan_nas", "GANInMeshAPI"),
    "fednas": ("gan_nas", "NASInMeshAPI"),
    "decentralized_fl": ("decentralized", "DecentralizedInMeshAPI"),
    "spreadgnn": ("decentralized", "SpreadGNNInMeshAPI"),
    "turbo_aggregate": ("turbo", "TurboAggregateInMeshAPI"),
    "hierarchicalfl": ("hierarchical", "HierarchicalInMeshAPI"),
}


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
        program = _PROGRAMS.get(opt)
        if program is None:
            from .xla.fed_sim import XLASimulator

            self.sim = XLASimulator(args, dataset, model, device)
        else:
            module, cls = program
            self.sim = getattr(importlib.import_module(f".xla.{module}", __package__), cls)(
                args, device, dataset, model)

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
