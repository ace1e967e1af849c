"""The RNN zoo of the port: counterpart of ``fedml_tpu/models/rnn.py``.

* ``RNN_OriginalFedAvg``: a 2-layer LSTM character model (shakespeare);
* ``RNN_FedShakespeare``: the same stack, the fed_shakespeare variant;
* ``RNN_StackOverFlow``: one LSTM and two dense layers (next-word
  prediction).

Input [B, L] int tokens, logits [B, L, vocab].  Each flax ``nn.RNN(
nn.LSTMCell(h))`` is an ``LSTMCell`` here, named as flax 0.12 names it: the
cell is built in the model's scope, so its leaves sit under ``LSTMCell_0``,
``LSTMCell_1`` (not under the ``nn.RNN``'s ``name=``).  A cell keeps flax's
eight dense layers: the input kernels ``ii``, ``if``, ``ig``, ``io`` without
bias and the recurrent ``hi``, ``hf``, ``hg``, ``ho`` with bias, where

    i = σ(ii x + hi h), f = σ(if x + hf h), g = tanh(ig x + hg h),
    o = σ(io x + ho h), c' = f c + i g, h' = o tanh(c').

The sequence runs through ``torch.lstm`` (cuDNN's LSTM on the card) with the
weights stacked in torch's gate order i, f, g, o ([4h, in] and [4h, h]),
the recurrent biases as ``b_ih`` and zeros as ``b_hh``; the carry starts at
zero, as ``nn.RNN``'s does.  Init is flax's: lecun-normal input kernels,
orthogonal recurrent kernels, zero biases, embeddings N(0, 1/dim).
"""

from __future__ import annotations

import warnings

import torch
from torch import nn

from .resnet import flax_init

GATES = ("i", "f", "g", "o")  # torch's row order of the stacked weights


class LSTMCell(nn.Module):
    def __init__(self, in_features: int, hidden: int, device=None):
        super().__init__()
        self.hidden = int(hidden)
        for gate in GATES:
            self.add_module(f"i{gate}", nn.Linear(in_features, hidden, bias=False,
                                                  device=device))
        for gate in GATES:
            layer = nn.Linear(hidden, hidden, device=device)
            layer.orthogonal = True  # flax's recurrent_kernel_init
            self.add_module(f"h{gate}", layer)

    def stacked(self):
        """(w_ih [4h, in], w_hh [4h, h], b [4h]) in the i, f, g, o order."""
        w_ih = torch.cat([getattr(self, f"i{g}").weight for g in GATES])
        w_hh = torch.cat([getattr(self, f"h{g}").weight for g in GATES])
        b = torch.cat([getattr(self, f"h{g}").bias for g in GATES])
        return w_ih, w_hh, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, L, in] -> the hidden states [B, L, h]."""
        w_ih, w_hh, b = self.stacked()
        h0 = torch.zeros((1, x.shape[0], self.hidden), dtype=x.dtype, device=x.device)
        with warnings.catch_warnings():
            # cuDNN compacts the stacked weights into its own buffer each call
            # (a copy of 4(in + h)h floats) and warns about it
            warnings.filterwarnings("ignore", message="RNN module weights are not part")
            # "train" keeps cuDNN's backward state: it follows autograd, not
            # the module's mode (the LSTM has no dropout), so an eval-mode
            # module still trains (FedSeg applies its model in eval mode)
            out, _, _ = torch.lstm(x, (h0, h0), [w_ih, w_hh, b, torch.zeros_like(b)], True, 1,
                                   0.0, torch.is_grad_enabled(), False, True)
        return out


class _LSTMStack(nn.Module):
    """``embed`` -> ``LSTMCell_{i}`` ... -> dense layers (``heads``)."""

    def __init__(self, vocab_size: int, embedding_dim: int, hidden: int, n_lstm: int,
                 heads, device=None):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, embedding_dim, device=device)
        self.n_lstm = n_lstm
        width = embedding_dim
        for i in range(n_lstm):
            self.add_module(f"LSTMCell_{i}", LSTMCell(width, hidden, device))
            width = hidden
        self.heads = [name for name, _ in heads]
        for name, out in heads:
            self.add_module(name, nn.Linear(width, out, device=device))
            width = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.embed(x.long())
        for i in range(self.n_lstm):
            x = getattr(self, f"LSTMCell_{i}")(x)
        for name in self.heads:
            x = getattr(self, name)(x)
        return x

    def init_parameters(self, generator: torch.Generator) -> None:
        flax_init(self, generator)


class RNN_OriginalFedAvg(_LSTMStack):
    def __init__(self, vocab_size: int = 90, embedding_dim: int = 8, hidden_size: int = 256,
                 device=None):
        super().__init__(vocab_size, embedding_dim, hidden_size, 2, [("head", vocab_size)],
                         device)


class RNN_FedShakespeare(_LSTMStack):
    def __init__(self, vocab_size: int = 90, embedding_dim: int = 8, hidden_size: int = 256,
                 device=None):
        super().__init__(vocab_size, embedding_dim, hidden_size, 2, [("head", vocab_size)],
                         device)


class RNN_StackOverFlow(_LSTMStack):
    """1 LSTM + 2 dense layers (``fc1`` to the embedding width, ``fc2``)."""

    def __init__(self, vocab_size: int = 10004, embedding_dim: int = 96,
                 hidden_size: int = 670, device=None):
        super().__init__(vocab_size, embedding_dim, hidden_size, 1,
                         [("fc1", embedding_dim), ("fc2", vocab_size)], device)
