"""The client packing of the in-mesh split-computation simulators
(counterpart of ``fedml_tpu/simulation/xla/split.py``).

Only ``_pad_clients`` is ported: the in-mesh decentralized round
(``simulation/xla/decentralized.py``) and the in-mesh FedGAN and FedNAS
rounds (``simulation/xla/gan_nas.py``) pack their clients' data with it.  The
split-computation programs themselves (VFL, SplitNN, FedGKT) are not ported
yet (ROADMAP.md queue A, item 5: the other simulators); ``SimulatorXLA``
refuses their optimizers.
"""

from __future__ import annotations

import numpy as np
import torch


def _pad_clients(local_train, local_num, num_clients: int, batch_size: int,
                 device: torch.device):
    """Concatenate the client shards into one array pair on ``device`` and
    give each client a row of indices padded to ``padded_n`` (the padding
    repeats the client's first row; its count masks it out): the round
    simulator's ``_pack_data`` layout, standalone.  Returns ``(x_all, y_all,
    idx [num_clients, padded_n], counts, padded_n)``; inputs are stored
    fp32, as the JAX package stores them."""
    counts = np.array([local_num[i] for i in range(num_clients)], np.int64)
    padded_n = max(batch_size, -(-int(counts.max()) // batch_size) * batch_size)
    xs, ys = [], []
    idx = np.zeros((num_clients, padded_n), np.int64)
    cursor = 0
    for i in range(num_clients):
        xi, yi = local_train[i]
        n = len(yi)
        xs.append(np.asarray(xi, np.float32))
        ys.append(np.asarray(yi))
        if n > 0:
            idx[i, :n] = np.arange(cursor, cursor + n)
            idx[i, n:] = cursor
        cursor += n
    device = torch.device(device)
    return (torch.from_numpy(np.concatenate(xs, 0)).to(device),
            torch.from_numpy(np.concatenate(ys, 0)).to(device),
            torch.from_numpy(idx).to(device), counts, padded_n)
