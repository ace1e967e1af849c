"""Device selection of the port (counterpart of ``fedml_tpu/device.py``).

Entry points run on the CUDA card.  ``get_device`` returns the CPU only when
the config asks for it (``device_args.device_type: cpu``, as the tests do),
and raises when no card is visible otherwise: it never falls back.
``fp32_matmul`` scopes full-fp32 products (TF32 off) to a block.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def fp32_matmul():
    """fp32 products in full fp32, never TF32, inside the block: cuBLAS's and
    cuDNN's TF32 flags are turned off on entry and set back to the values
    found on exit, so nothing leaks to code that runs after the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
