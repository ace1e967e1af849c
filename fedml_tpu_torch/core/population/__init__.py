"""Client population of the port: registry, uniform policy, manager."""

from .manager import PopulationManager  # noqa: F401
from .policies import UniformPolicy, make_policy  # noqa: F401
from .registry import ClientRegistry  # noqa: F401
