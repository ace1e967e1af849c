"""Simulator dispatch of the port (counterpart of
``fedml_tpu/simulation/simulator.py``): backend ``XLA`` (and ``MPI`` /
``NCCL``, as in the JAX package) runs the round simulator on one card."""

from __future__ import annotations

from ..constants import (
    FEDML_SIMULATION_TYPE_MPI,
    FEDML_SIMULATION_TYPE_NCCL,
    FEDML_SIMULATION_TYPE_SP,
    FEDML_SIMULATION_TYPE_XLA,
)


class SimulatorXLA:
    def __init__(self, args, device, dataset, model):
        from .xla.fed_sim import XLASimulator

        self.sim = XLASimulator(args, dataset, model, device)

    def run(self):
        return self.sim.train()


def create_simulator(args, device, dataset, model):
    backend = str(getattr(args, "backend", FEDML_SIMULATION_TYPE_SP))
    if backend in (FEDML_SIMULATION_TYPE_XLA, FEDML_SIMULATION_TYPE_MPI,
                   FEDML_SIMULATION_TYPE_NCCL):
        return SimulatorXLA(args, device, dataset, model)
    if backend in (FEDML_SIMULATION_TYPE_SP, "MPI_PROC"):
        raise NotImplementedError(
            f"simulation backend {backend!r} is not ported yet "
            "(ROADMAP.md queue A, item 13: other simulators)")
    raise ValueError(f"unknown simulation backend {backend!r}")
