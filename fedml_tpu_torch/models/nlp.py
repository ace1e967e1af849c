"""FedNLP task encoders of the port (counterpart of
``fedml_tpu/models/nlp.py``): a compact bidirectional transformer encoder
with a classification, tagging or span head.

Each is the TransformerLM's embedding and blocks (``models/transformer.py``
``Block``) with non-causal attention, then an RMSNorm ``final_norm`` and a
dense head with bias: ``cls_head`` on the mean over positions (GAP pooling),
``tag_head`` and ``span_head`` on every position.  The blocks attend through
``reference_attention(q, k, v, causal=False)``, plain torch ops, as the JAX
modules attend through their XLA reference: no Pallas kernel lies under
these encoders, so none of the port's kernels does either.

Modules are built on whatever device is given (the hub builds on ``meta``);
``init_parameters`` fills them from a ``torch.Generator`` with the flax
initialisers' distributions, the heads' biases zero.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.flash_attention import reference_attention
from .transformer import Block, RMSNorm, TransformerConfig


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return reference_attention(q, k, v, causal=False)


class _Encoder(nn.Module):
    """Token ids [B, L] -> the final-normed encoder states [B, L, d_model];
    a subclass names its head and applies it in ``forward``."""

    head_name = ""

    def __init__(self, out_dim: int, vocab_size: int = 32000, d_model: int = 128,
                 n_heads: int = 4, n_layers: int = 2, d_ff: int = 256, device=None):
        super().__init__()
        self.cfg = TransformerConfig(vocab_size=vocab_size, d_model=d_model, n_heads=n_heads,
                                     n_layers=n_layers, d_ff=d_ff)
        self.embed = nn.Embedding(vocab_size, d_model, dtype=torch.float32, device=device)
        self.layers = nn.ModuleList(
            Block(self.cfg, bidirectional_attention, device=device) for _ in range(n_layers))
        self.final_norm = RMSNorm(d_model, device=device)
        setattr(self, self.head_name, nn.Linear(d_model, out_dim, dtype=torch.float32,
                                                device=device))

    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        x = self.embed(tokens)
        for layer in self.layers:
            x = layer(x, positions)
        return self.final_norm(x)

    def init_parameters(self, generator: torch.Generator) -> None:
        """The flax initialisers' distributions: embedding N(0, 1/d_model);
        every kernel lecun-normal (a normal truncated at two standard
        deviations, rescaled to std 1/sqrt(fan_in)); norms one; biases
        zero."""
        trunc_std = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("norm.weight"):
                    p.fill_(1.0)
                elif name.endswith("bias"):
                    p.zero_()
                elif name == "embed.weight":
                    p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
                else:
                    std = 1.0 / math.sqrt(p.shape[1]) / trunc_std
                    nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                                          generator=generator)


class TransformerClassifier(_Encoder):
    """Token ids [B, L] -> class logits [B, num_classes] (mean-pooled)."""

    head_name = "cls_head"

    def __init__(self, num_classes: int, **kw):
        super().__init__(num_classes, **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.cls_head(self.encode(tokens).mean(dim=1))


class TransformerTagger(_Encoder):
    """Token ids [B, L] -> per-token tag logits [B, L, num_tags]."""

    head_name = "tag_head"

    def __init__(self, num_tags: int, **kw):
        super().__init__(num_tags, **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.tag_head(self.encode(tokens))


class TransformerSpanExtractor(_Encoder):
    """Token ids [B, L] -> span logits [B, L, 2] (start, end)."""

    head_name = "span_head"

    def __init__(self, **kw):
        super().__init__(2, **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.span_head(self.encode(tokens))
