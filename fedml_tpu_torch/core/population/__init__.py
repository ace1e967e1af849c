"""Client population of the port: registry, selection policies, pacer
arithmetic, the stacked whole-run draw and the manager."""

from .manager import PopulationManager  # noqa: F401
from .pacer import RoundPacer  # noqa: F401
from .policies import (ImportancePolicy, SelectionPolicy, StratifiedBySpeedPolicy,  # noqa: F401
                       UniformPolicy, make_policy)
from .registry import ClientRegistry  # noqa: F401
from .stacked import stacked_cohorts  # noqa: F401
