"""Device selection of the port (counterpart of ``fedml_tpu/device.py``).

Entry points run on the CUDA card.  ``get_device`` returns the CPU only when
the config asks for it (``device_args.device_type: cpu``, as the tests do),
and raises when no card is visible otherwise: it never falls back.
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger(__name__)


def get_device(args=None) -> torch.device:
    kind = str(getattr(args, "device_type", "") or "").lower()
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; the port runs on the card unless the config "
            "sets device_args.device_type: cpu")
    dev = torch.device("cuda", int(getattr(args, "gpu_id", 0) or 0))
    logger.info("cuda devices: %d (using %s, %s)", torch.cuda.device_count(), dev,
                torch.cuda.get_device_name(dev))
    return dev
