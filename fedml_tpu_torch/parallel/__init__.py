"""Parallelism layer of the port: the mesh record, ring attention and the
sequence-parallel TransformerLM (counterpart of ``fedml_tpu/parallel``).

On one card the mesh's axes are loops and a leading shard axis on that card;
the multi-card ring over ``torch.distributed`` is ROADMAP.md queue A, item 12: the ring across
cards.
"""

from .mesh import Mesh, create_mesh, create_train_mesh
from .ring_attention import ring_attention, ring_attention_inner

__all__ = ["Mesh", "create_mesh", "create_train_mesh", "ring_attention", "ring_attention_inner"]
