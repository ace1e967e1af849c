"""The mesh of the port: a record of named axis sizes on one device.

Counterpart of ``create_mesh`` and ``create_train_mesh`` in
``fedml_tpu/parallel/mesh.py``.  The JAX package lays a ``jax.sharding.Mesh``
over as many devices as its axes multiply to; the port runs on one card, so a
mesh here only names the axes and their sizes and the one device that holds
every shard.  Code that runs over an axis reads its size from the record
(``mesh.shape["sp"]``) and loops, or keeps the shards along a leading axis,
on ``mesh.device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..constants import MESH_AXIS_DP, MESH_AXIS_SP, MESH_AXIS_TP
from ..device import get_device


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))


def create_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
                device: Optional[torch.device] = None) -> Mesh:
    """A mesh of the named axes on ``device`` (the card unless the caller
    passes another device; raises without a card, see ``device.get_device``)."""
    sizes = tuple(int(s) for s in axis_sizes)
    names = tuple(str(n) for n in axis_names)
    if len(sizes) != len(names):
        raise ValueError(f"{len(sizes)} axis sizes for {len(names)} axis names")
    if any(s < 1 for s in sizes):
        raise ValueError(f"axis sizes must be >= 1, got {sizes}")
    if len(set(names)) != len(names):
        raise ValueError(f"axis names must differ, got {names}")
    dev = torch.device(device) if device is not None else get_device()
    if dev.type == "cuda" and dev.index is None:  # "cuda" names the current card
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(names, sizes, dev)


def create_train_mesh(dp: int = 1, tp: int = 1, sp: int = 1,
                      device: Optional[torch.device] = None) -> Mesh:
    """dp x tp x sp mesh for the distributed trainer."""
    return create_mesh((dp, tp, sp), (MESH_AXIS_DP, MESH_AXIS_TP, MESH_AXIS_SP), device)
