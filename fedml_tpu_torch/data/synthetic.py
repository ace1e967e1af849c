"""Synthetic stand-in corpora (numpy only), copied from
``fedml_tpu/data/synthetic.py`` so the port draws bit-identical arrays from
the same seeds.  Only the generators the ported slice needs are here."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_next_token_corpus(
    n: int, seq_len: int, vocab_size: int, seed: int = 0, proto_seed: int = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Markov-chain token streams for next-word-prediction tasks: x=[n,L],
    y=[n,L] (x shifted by one).  ``proto_seed`` fixes the transition matrix
    (the "language") independently of the sampled sequences."""
    rng = np.random.RandomState(seed)
    proto_rng = np.random.RandomState(seed if proto_seed is None else proto_seed)
    # sparse row-stochastic transition matrix with strong structure
    trans = proto_rng.dirichlet(np.full(vocab_size, 0.05), size=vocab_size)
    seqs = np.empty((n, seq_len + 1), dtype=np.int32)
    state = rng.randint(0, vocab_size, size=n)
    seqs[:, 0] = state
    for t in range(1, seq_len + 1):
        u = rng.rand(n)
        cdf = np.cumsum(trans[seqs[:, t - 1]], axis=1)
        seqs[:, t] = (u[:, None] > cdf).sum(axis=1)
    return seqs[:, :-1], seqs[:, 1:]
