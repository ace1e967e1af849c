"""Models of the port (``fedml_tpu_torch.models.hub.create``)."""

from . import hub  # noqa: F401
