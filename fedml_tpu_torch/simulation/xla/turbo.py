"""In-mesh Turbo-Aggregate of the port (counterpart of
``fedml_tpu/simulation/xla/turbo.py``): ``TurboAggregateInMeshAPI``, which
``SimulatorXLA`` builds for ``federated_optimizer`` ``turbo_aggregate``.

The JAX package compiles the round into one XLA program over the ``client``
mesh axis: the slots train the global model as FedAvg does, a one-hot(group)
contraction with a ``psum`` gives the L group sums, and a ring walk over the
groups masks them.  On one card that is the ``sp`` twin's round
(``TurboAggregateAPI``: the cohort of ``core/sampling`` split by sampled
position into L = ``min(ta_group_num, cohort)`` groups, the ring of masks
drawn from its CPU generator seeded ``random_seed + 404``, the
after-aggregation hooks every round), with each client trained as the JAX
round trains it (``PaddedClients`` of ``hierarchical.py``: on its rows
padded to ``padded_n``, its shuffles seeded from (seed, round, client)).
The masks telescope away up to fp32 rounding, which scales with the masks
(unit normals).

The JAX round runs only the after-aggregation hooks: attacks, the before-
and on-aggregation defenses, data poisoning and local DP are refused when
the object is built.  ``frequency_of_the_test`` 0 runs without an eval, as
in JAX.
"""

from __future__ import annotations

from ..sp.turboaggregate.ta_api import TurboAggregateAPI
from .hierarchical import PaddedClients


class TurboAggregateInMeshAPI(PaddedClients, TurboAggregateAPI):
    pass
