"""Decentralized-FL topology managers (counterpart of
``fedml_tpu/core/distributed/topology/topology_manager.py``, copied as it is:
numpy only, so the same seed gives the same mixing matrix bit for bit).

``SymmetricTopologyManager`` builds a ring + random Watts-Strogatz-style
symmetric neighbor graph with a row-normalized mixing (confusion) matrix;
``AsymmetricTopologyManager`` the directed variant.  The mixing matrix is
what the decentralized algorithms consume: the port's
``simulation/sp/decentralized`` gossips with one ``torch.tensordot`` by it.
The rest of ``core/distributed/`` (the message plane) is not ported yet
(ROADMAP.md queue A, item 9a: transport and cross-silo FedAvg).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List

import numpy as np


class BaseTopologyManager(ABC):
    @abstractmethod
    def generate_topology(self) -> None:
        ...

    @abstractmethod
    def get_in_neighbor_idx_list(self, node_index: int) -> List[int]:
        ...

    @abstractmethod
    def get_out_neighbor_idx_list(self, node_index: int) -> List[int]:
        ...


class SymmetricTopologyManager(BaseTopologyManager):
    """Ring + ``neighbor_num`` random symmetric extra edges per node."""

    def __init__(self, n: int, neighbor_num: int = 2, seed: int = 0):
        self.n = int(n)
        self.neighbor_num = int(neighbor_num)
        self.seed = seed
        self.topology = np.zeros((self.n, self.n))

    def generate_topology(self) -> None:
        n = self.n
        rng = np.random.RandomState(self.seed)
        adj = np.eye(n)
        for i in range(n):  # ring
            adj[i, (i + 1) % n] = 1
            adj[i, (i - 1) % n] = 1
        extra = max(0, self.neighbor_num - 2)
        for i in range(n):  # random symmetric rewires (WS-flavored)
            if extra > 0:
                cand = [j for j in range(n) if j != i and adj[i, j] == 0]
                if cand:
                    for j in rng.choice(cand, size=min(extra, len(cand)), replace=False):
                        adj[i, j] = adj[j, i] = 1
        # row-normalized mixing matrix (uniform over neighbors incl. self)
        self.topology = adj / adj.sum(axis=1, keepdims=True)

    def get_in_neighbor_idx_list(self, node_index: int) -> List[int]:
        return [j for j in range(self.n) if self.topology[j, node_index] > 0]

    def get_out_neighbor_idx_list(self, node_index: int) -> List[int]:
        return [j for j in range(self.n) if self.topology[node_index, j] > 0]

    def get_symmetric_neighbor_list(self, node_index: int) -> np.ndarray:
        return self.topology[node_index]


class AsymmetricTopologyManager(BaseTopologyManager):
    """Directed graph: each node sends to ``out_neighbor_num`` random peers."""

    def __init__(self, n: int, out_neighbor_num: int = 2, seed: int = 0):
        self.n = int(n)
        self.out_neighbor_num = int(out_neighbor_num)
        self.seed = seed
        self.topology = np.zeros((self.n, self.n))

    def generate_topology(self) -> None:
        n = self.n
        rng = np.random.RandomState(self.seed)
        adj = np.eye(n)
        for i in range(n):
            adj[i, (i + 1) % n] = 1  # keep strong connectivity via ring
            cand = [j for j in range(n) if j != i and adj[i, j] == 0]
            k = min(max(0, self.out_neighbor_num - 1), len(cand))
            if k:
                for j in rng.choice(cand, size=k, replace=False):
                    adj[i, j] = 1
        self.topology = adj / adj.sum(axis=1, keepdims=True)

    def get_in_neighbor_idx_list(self, node_index: int) -> List[int]:
        return [j for j in range(self.n) if self.topology[j, node_index] > 0]

    def get_out_neighbor_idx_list(self, node_index: int) -> List[int]:
        return [j for j in range(self.n) if self.topology[node_index, j] > 0]
