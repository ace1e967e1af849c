"""Per-round client sampling (copy of ``fedml_tpu/core/sampling.py``).

Seeded by round index so every simulator backend draws the SAME client
schedule for a given round.  The draw comes from a local
``np.random.RandomState(round_idx)``, never from the process-global NumPy
RNG; ``RandomState(s).choice(n, k, replace=False)`` is bit-identical to the
reference's ``np.random.seed(s)`` + ``np.random.choice(range(n), k,
replace=False)``.  This is the ``uniform`` selection policy's schedule
(``core/population/policies.py``).
"""

from __future__ import annotations

import numpy as np


def client_sampling(round_idx: int, client_num_in_total: int, client_num_per_round: int) -> np.ndarray:
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total)
    rs = np.random.RandomState(round_idx)
    return rs.choice(client_num_in_total, client_num_per_round, replace=False)
