"""Decoder-only Transformer LM of the port (``torch.nn``).

Counterpart of ``fedml_tpu/models/transformer.py`` with the same parameter
shapes and numerics:

* RMSNorm with epsilon 1e-6 and fp32 statistics (flax ``nn.RMSNorm``);
* RoPE on concatenated halves with frequencies ``1/base**(arange(half)/half)``;
* a fused q/k/v projection whose output splits as (3, H, Dh), an output
  projection contracting (H, Dh), and a SwiGLU MLP, all without bias;
* an injectable ``attention_fn`` over [B, L, H, D] tensors, by default the
  causal flash attention of ``ops/flash_attention.py``.

Parameters are created on whatever device the module is built on; the hub
builds on the ``meta`` device and ``TransformerLM.init_parameters`` fills them from an
explicit ``torch.Generator`` with the flax initialisers' distributions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 256
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 1024
    max_seq_len: int = 2048
    dropout: float = 0.0
    dtype: torch.dtype = torch.float32


def rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: [B, L, H, D], positions: [B, L] absolute indices."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].float() * freqs  # [B, L, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Default attention: [B, L, H, D] -> [B, L, H, D], causal flash attention
    (the CUDA kernels on the card, their plain versions on the CPU)."""
    from ..ops.flash_attention import attention

    return attention(q, k, v, causal=True)


AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: y = x * (rsqrt(mean(x^2) + eps) * scale), the
    statistics in fp32, the result in the compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mul = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps) * self.weight
        return (xf * mul).to(self.dtype)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, attention_fn: AttentionFn = causal_attention,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.attention_fn = attention_fn
        d, h = cfg.d_model, cfg.n_heads
        self.d_head = d // h
        lin = dict(bias=False, dtype=torch.float32, device=device)
        self.attn_norm = RMSNorm(d, dtype=cfg.dtype, device=device)
        self.qkv = nn.Linear(d, 3 * h * self.d_head, **lin)
        self.out_proj = nn.Linear(h * self.d_head, d, **lin)
        self.mlp_norm = RMSNorm(d, dtype=cfg.dtype, device=device)
        self.wi_gate = nn.Linear(d, cfg.d_ff, **lin)
        self.wi_up = nn.Linear(d, cfg.d_ff, **lin)
        self.wo = nn.Linear(cfg.d_ff, d, **lin)

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, layer.weight.to(self.cfg.dtype))

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, L, _ = x.shape
        h = self.attn_norm(x)
        qkv = self._dense(self.qkv, h).view(B, L, 3, cfg.n_heads, self.d_head)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = rope(q, positions)
        k = rope(k, positions)
        attn = self.attention_fn(q, k, v)
        x = x + self._dense(self.out_proj, attn.reshape(B, L, cfg.n_heads * self.d_head))
        h = self.mlp_norm(x)
        gate = self._dense(self.wi_gate, h)
        up = self._dense(self.wi_up, h)
        return x + self._dense(self.wo, F.silu(gate) * up)


class TransformerLM(nn.Module):
    def __init__(self, cfg: TransformerConfig, attention_fn: AttentionFn = causal_attention,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=torch.float32,
                                  device=device)
        self.layers = nn.ModuleList(
            Block(cfg, attention_fn, device=device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=device)
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False, dtype=torch.float32,
                                 device=device)

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None):
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        x = self.embed(tokens).to(self.cfg.dtype)
        for layer in self.layers:
            x = layer(x, positions)
        x = self.final_norm(x)
        return F.linear(x, self.lm_head.weight.to(self.cfg.dtype))

    def init_parameters(self, generator: torch.Generator) -> None:
        """Fill the parameters in place with the flax initialisers'
        distributions: embedding N(0, 1/d_model); every kernel lecun-normal (a
        normal truncated at two standard deviations, rescaled to std
        1/sqrt(fan_in)); norms one."""
        trunc_std = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("norm.weight"):
                    p.fill_(1.0)
                elif name == "embed.weight":
                    p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
                else:
                    std = 1.0 / math.sqrt(p.shape[1]) / trunc_std
                    nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                                          generator=generator)
