"""fedml_tpu_torch — the PyTorch / CUDA port of fedml_tpu for one NVIDIA H100.

The JAX package ``fedml_tpu`` is the reference; this package is its port,
slice by slice (ROADMAP.md), with the same public surface:
``fedml_tpu_torch.init``, ``run_simulation``, ``FedMLRunner``,
``data.load``, ``models.hub.create`` and ``device.get_device``.  It imports
``torch`` and never JAX or anything of ``fedml_tpu``.
"""

from __future__ import annotations

import logging
import random as _random

import numpy as _np
import torch as _torch

__version__ = "0.1.0"

from . import constants  # noqa: E402,F401
from .arguments import Arguments, load_arguments  # noqa: E402
from .runner import FedMLRunner  # noqa: E402,F401
from . import data, device, models  # noqa: E402,F401

_logger = logging.getLogger(__name__)

# switches whose subsystems are not ported yet
_REFUSED = (("using_mlops", "queue A, item 9d: the rest of the message plane (mlops)"),)


def init(args: Arguments | None = None, should_init_logs: bool = True) -> Arguments:
    """Bootstrap: load and validate the config, refuse the subsystems the port
    does not have, seed ``random``, numpy and torch from ``random_seed``, and
    initialise the attacker, defender and DP singletons from the config."""
    if args is None:
        args = load_arguments()
    if hasattr(args, "validate"):
        args.validate(for_training=bool(getattr(args, "training_type", None)))
    for key, item in _REFUSED:
        if getattr(args, key, False):
            raise NotImplementedError(f"{key} is not ported yet (ROADMAP.md {item})")
    if should_init_logs:
        logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(name)s] %(message)s")
    seed = int(getattr(args, "random_seed", 0))
    # run-entry seeding; library code draws from explicit generators
    _random.seed(seed)
    _np.random.seed(seed)
    _torch.manual_seed(seed)

    from .core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
    from .core.security.fedml_attacker import FedMLAttacker
    from .core.security.fedml_defender import FedMLDefender

    FedMLAttacker.get_instance().init(args)
    FedMLDefender.get_instance().init(args)
    FedMLDifferentialPrivacy.get_instance().init(args)

    if not hasattr(args, "client_id_list"):
        n = int(getattr(args, "client_num_in_total", 0) or 0)
        args.client_id_list = list(range(1, n + 1))
    _logger.info("fedml_tpu_torch %s initialized (training_type=%s backend=%s)",
                 __version__, getattr(args, "training_type", None), getattr(args, "backend", None))
    return args


def run_simulation(backend: str = "sp"):
    """One-liner: config from the command line, then the simulator's run."""
    from .constants import FEDML_TRAINING_PLATFORM_SIMULATION

    args = load_arguments(FEDML_TRAINING_PLATFORM_SIMULATION, backend)
    args.training_type = FEDML_TRAINING_PLATFORM_SIMULATION
    args.backend = getattr(args, "backend", None) or backend
    args = init(args)
    dev = device.get_device(args)
    dataset, output_dim = data.data_loader.load(args)
    model = models.hub.create(args, output_dim)
    return FedMLRunner(args, dev, dataset, model).run()
