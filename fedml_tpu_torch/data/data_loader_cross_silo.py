"""Cross-silo intra-silo data split (counterpart of
``fedml_tpu/data/data_loader_cross_silo.py``, numpy, copied): divide a
silo's local data across its intra-silo trainer ranks."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def split_data_for_dist_trainers(train_data: Tuple[np.ndarray, np.ndarray],
                                 n_proc_in_silo: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(x, y) -> n near-equal shards (contiguous; order preserved)."""
    x, y = train_data
    n = max(int(n_proc_in_silo), 1)
    xs = np.array_split(np.asarray(x), n)
    ys = np.array_split(np.asarray(y), n)
    return list(zip(xs, ys))
