"""Fleet registry of the port (the part of
``fedml_tpu/core/population/registry.py`` the uniform policy uses): client
ids and the blocklist."""

from __future__ import annotations

from typing import Sequence

import numpy as np


class ClientRegistry:
    def __init__(self, client_ids: Sequence[int]):
        self.ids = np.asarray(list(client_ids), dtype=np.int64)
        if self.ids.ndim != 1 or self.ids.size == 0:
            raise ValueError("client_ids must be a non-empty 1-D sequence")
        if np.unique(self.ids).size != self.ids.size:
            raise ValueError("client_ids must be unique")
        self._pos = {int(c): i for i, c in enumerate(self.ids)}
        self._blocked = np.zeros(self.ids.size, bool)

    def positions(self, client_ids) -> np.ndarray:
        return np.asarray([self._pos[int(c)] for c in np.asarray(client_ids).reshape(-1)],
                          np.int64)

    def blocklist(self, client_ids) -> None:
        self._blocked[self.positions(client_ids)] = True

    def eligible_ids(self) -> np.ndarray:
        """Ids a policy may draw from (registry order, blocklist excluded)."""
        return self.ids[~self._blocked]
