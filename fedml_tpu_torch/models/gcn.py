"""Graph neural networks of the port (the FedGraphNN family): counterpart of
``fedml_tpu/models/gcn.py``.

A dense-adjacency GCN over fixed-size padded graphs.  Each sample is
``[N, F + N]``: node features [N, F] concatenated with the dense adjacency
[N, N] (the model adds the self loops).  Padding nodes have all-zero feature
rows.

One shared encoder (``gcn_encode`` over the ``gc<i>`` layers) feeds four
heads: graph classification (``GCN``, also the multi-task model with one
logit a task), link prediction (``GCNLinkPred``), per-node classification
(``GCNNodeClassifier``) and property regression (``GCNRegressor``).  Each
layer is ``a_norm @ Linear(h)``, the bias inside the propagation, then
``relu(...) * mask``; the node mask comes from the raw features.  The
adjacency products and the pairwise scores are plain torch matmuls, as the
JAX package computes them in XLA: no Pallas kernel lies under these models,
so none of the port's kernels does either.

Modules are built on whatever device is given (the hub builds on ``meta``);
``init_parameters`` fills them from a ``torch.Generator`` with flax
``Dense``'s distributions (a lecun-normal kernel, a zero bias) and a zero
``score_bias``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def unpack_graph(x: torch.Tensor, feat_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N, F+N] -> (features [B, N, F], adjacency [B, N, N])."""
    return x[..., :feat_dim], x[..., feat_dim:]


def gcn_encode(layers: Sequence[nn.Module], x: torch.Tensor,
               feat_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized-adjacency message passing through ``layers``: returns
    (node states [B, N, H], node mask [B, N]); padding nodes stay silent."""
    feats, adj = unpack_graph(x, feat_dim)
    n = adj.shape[-1]
    # D^-1/2 (A + I) D^-1/2, the degree clipped at 1e-6
    a = adj + torch.eye(n, dtype=adj.dtype, device=adj.device)
    dinv = 1.0 / torch.sqrt(a.sum(-1).clamp_min(1e-6))
    a_norm = a * dinv[..., :, None] * dinv[..., None, :]
    node_mask = (feats.abs().sum(-1) > 0).to(feats.dtype)
    h = feats
    for layer in layers:
        h = a_norm @ layer(h)
        h = torch.relu(h) * node_mask[..., None]
    return h, node_mask


def masked_mean_pool(h: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """[B, N, H] -> [B, H], the mean over real nodes."""
    return h.sum(dim=-2) / node_mask.sum(-1, keepdim=True).clamp_min(1.0)


class _GCNBase(nn.Module):
    """The ``gc<i>`` encoder layers; a subclass adds its head."""

    def __init__(self, feat_dim: int, hidden: int = 64, n_layers: int = 2, device=None):
        super().__init__()
        self.feat_dim, self.hidden, self.n_layers = int(feat_dim), int(hidden), int(n_layers)
        for i in range(self.n_layers):
            setattr(self, f"gc{i}", self._dense(self.feat_dim if i == 0 else self.hidden,
                                                self.hidden, device))

    @staticmethod
    def _dense(n_in: int, n_out: int, device) -> nn.Linear:
        return nn.Linear(n_in, n_out, dtype=torch.float32, device=device)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        layers = [getattr(self, f"gc{i}") for i in range(self.n_layers)]
        return gcn_encode(layers, x, self.feat_dim)

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for name, p in self.named_parameters():
                if p.dim() < 2:  # biases and the 0-d score bias
                    p.zero_()
                else:
                    std = 1.0 / math.sqrt(p.shape[1]) / _TRUNC_STD
                    nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                                          generator=generator)


class GCN(_GCNBase):
    """Graph-level classifier: GCN layers, masked mean pooling, ``readout``."""

    def __init__(self, num_classes: int, feat_dim: int, hidden: int = 64, n_layers: int = 2,
                 device=None):
        super().__init__(feat_dim, hidden, n_layers, device)
        self.readout = self._dense(self.hidden, num_classes, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, node_mask = self.encode(x)
        return self.readout(masked_mean_pool(h, node_mask))


class GCNLinkPred(_GCNBase):
    """Link predictor: node embeddings ``z = embed(h) * mask``, then every
    pair scored at once, ``z zᵀ / sqrt(hidden) + score_bias`` [B, N, N]."""

    def __init__(self, feat_dim: int, hidden: int = 64, n_layers: int = 2, device=None):
        super().__init__(feat_dim, hidden, n_layers, device)
        self.embed = self._dense(self.hidden, self.hidden, device)
        self.score_bias = nn.Parameter(torch.zeros((), dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, node_mask = self.encode(x)
        z = self.embed(h) * node_mask[..., None]
        scores = (z @ z.transpose(-1, -2)) / math.sqrt(float(self.hidden))
        return scores + self.score_bias


class GCNNodeClassifier(_GCNBase):
    """Per-node classifier: GCN layers without pooling -> node logits
    [B, N, C] (the per-token masked CE of [B, N] node labels)."""

    def __init__(self, num_classes: int, feat_dim: int, hidden: int = 64, n_layers: int = 2,
                 device=None):
        super().__init__(feat_dim, hidden, n_layers, device)
        self.node_head = self._dense(self.hidden, num_classes, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, _ = self.encode(x)
        return self.node_head(h)


class GCNRegressor(_GCNBase):
    """Graph-level regressor: GCN layers, masked mean pooling, ``reg_head``."""

    def __init__(self, feat_dim: int, hidden: int = 64, n_layers: int = 2, out_dim: int = 1,
                 device=None):
        super().__init__(feat_dim, hidden, n_layers, device)
        self.reg_head = self._dense(self.hidden, out_dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, node_mask = self.encode(x)
        return self.reg_head(masked_mean_pool(h, node_mask))
