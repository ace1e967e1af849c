"""Data loading of the port (``fedml_tpu_torch.data.load``)."""

from .data_loader import DATASET_SPECS, load, load_centralized  # noqa: F401
