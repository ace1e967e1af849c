"""Runner dispatch of the port (counterpart of ``fedml_tpu/runner.py``):
(training_type, backend) -> runner with ``.run()``.  Simulation is ported;
cross-silo and cross-device runners come with the message plane (ROADMAP.md
queue A, item 16)."""

from __future__ import annotations

from .constants import FEDML_TRAINING_PLATFORM_SIMULATION


class FedMLRunner:
    def __init__(self, args, device, dataset, model, client_trainer=None,
                 server_aggregator=None):
        self.args = args
        training_type = str(getattr(args, "training_type", FEDML_TRAINING_PLATFORM_SIMULATION))
        if training_type != FEDML_TRAINING_PLATFORM_SIMULATION:
            raise NotImplementedError(
                f"training_type {training_type!r} is not ported yet "
                "(ROADMAP.md queue A, item 16: message plane)")
        from .simulation.simulator import create_simulator

        self.runner = create_simulator(args, device, dataset, model)

    def run(self):
        return self.runner.run()
