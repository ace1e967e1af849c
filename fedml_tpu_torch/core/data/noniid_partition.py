"""Non-IID data partitioning (copy of fedml_tpu/core/data/noniid_partition.py).

Parity with reference ``core/data/noniid_partition.py`` (Dirichlet LDA,
``non_iid_partition_with_dirichlet_distribution`` :6 and
``partition_class_samples_with_dirichlet_distribution`` :87), plus the
homogeneous split used by the hetero/homo ``partition_method`` switch in the
data loaders, and a quantity-skew partition.  All numpy-side (host data prep
— partitioning never runs on device).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def partition_class_samples_with_dirichlet_distribution(
    N: int,
    alpha: float,
    client_num: int,
    idx_batch: List[List[int]],
    idx_k: np.ndarray,
    rng: np.random.RandomState,
):
    """Split one class's sample indices across clients ~ Dir(alpha), balancing
    so no client exceeds N/client_num (the standard LDA recipe,
    arXiv:1909.06335; reference :87-117)."""
    rng.shuffle(idx_k)
    shares = rng.dirichlet(alpha * np.ones(client_num))
    # capacity-balance: clients already holding >= N/client_num samples are
    # frozen out of this class's draw, and the rest renormalized
    sizes = np.array([len(b) for b in idx_batch], dtype=np.float64)
    shares = np.where(sizes < N / client_num, shares, 0.0)
    shares /= shares.sum()
    # convert shares to split points over this class's samples
    cuts = np.floor(np.cumsum(shares[:-1]) * len(idx_k)).astype(np.int64)
    for client, chunk in enumerate(np.split(idx_k, cuts)):
        idx_batch[client] = idx_batch[client] + chunk.tolist()
    min_size = min(len(b) for b in idx_batch)
    return idx_batch, min_size


def non_iid_partition_with_dirichlet_distribution(
    label_list: np.ndarray,
    client_num: int,
    classes: int,
    alpha: float,
    seed: int = 0,
) -> Dict[int, np.ndarray]:
    """LDA partition (reference :6-60): per class, draw client shares from
    Dir(alpha); resample until every client has at least ~10 samples."""
    rng = np.random.RandomState(seed)
    net_dataidx_map: Dict[int, np.ndarray] = {}
    min_size = 0
    N = len(label_list)
    idx_batch: List[List[int]] = [[] for _ in range(client_num)]
    guard = 0
    while min_size < min(10, max(1, N // max(client_num, 1) // 2)) and guard < 1000:
        guard += 1
        idx_batch = [[] for _ in range(client_num)]
        for k in range(classes):
            idx_k = np.where(label_list == k)[0]
            if len(idx_k) == 0:
                continue
            idx_batch, min_size = partition_class_samples_with_dirichlet_distribution(
                N, alpha, client_num, idx_batch, idx_k, rng
            )
    for i in range(client_num):
        rng.shuffle(idx_batch[i])
        net_dataidx_map[i] = np.array(idx_batch[i], dtype=np.int64)
    return net_dataidx_map


def homo_partition(n_samples: int, client_num: int, seed: int = 0) -> Dict[int, np.ndarray]:
    """IID split: shuffle indices and deal them round-robin-equally."""
    rng = np.random.RandomState(seed)
    idxs = rng.permutation(n_samples)
    batch_idxs = np.array_split(idxs, client_num)
    return {i: np.asarray(batch_idxs[i], dtype=np.int64) for i in range(client_num)}


def quantity_skew_partition(
    n_samples: int, client_num: int, alpha: float, seed: int = 0
) -> Dict[int, np.ndarray]:
    """Sample counts ~ Dir(alpha) (label distribution stays IID)."""
    rng = np.random.RandomState(seed)
    idxs = rng.permutation(n_samples)
    proportions = rng.dirichlet(np.repeat(alpha, client_num))
    cuts = (np.cumsum(proportions) * n_samples).astype(int)[:-1]
    parts = np.split(idxs, cuts)
    return {i: np.asarray(parts[i], dtype=np.int64) for i in range(client_num)}
