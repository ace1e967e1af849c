"""Synthetic stand-in corpora (numpy only), copied from
``fedml_tpu/data/synthetic.py`` so the port draws bit-identical arrays from
the same seeds.  Only the generators the ported slices need are here: the
class-prototype images and features (``make_classification``) and the
next-word-prediction corpus."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_classification(
    n: int,
    num_classes: int,
    feature_shape: Tuple[int, ...],
    seed: int = 0,
    noise: float = 0.35,
    dirichlet_label_skew: float = 0.0,
    proto_seed: int = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-prototype + gaussian-noise images/features, labels uniform (or
    Dir-skewed when ``dirichlet_label_skew`` > 0).  Images come out NHWC.

    ``proto_seed`` fixes the class prototypes independently of the sample
    seed so train and test splits share one distribution (pass the same
    proto_seed with different ``seed``)."""
    rng = np.random.RandomState(seed)
    proto_rng = np.random.RandomState(seed if proto_seed is None else proto_seed)
    dim = int(np.prod(feature_shape))
    protos = proto_rng.randn(num_classes, dim).astype(np.float32)
    # low-frequency structure: smooth prototypes so convs have something to find
    if len(feature_shape) >= 2:
        h, w = feature_shape[0], feature_shape[1]
        yy, xx = np.mgrid[0:h, 0:w]
        for c in range(num_classes):
            fx, fy = 1 + c % 3, 1 + (c // 3) % 3
            wave = np.sin(2 * np.pi * fx * xx / w) * np.cos(2 * np.pi * fy * yy / h)
            p = protos[c].reshape(feature_shape)
            p += 1.5 * wave[(...,) + (None,) * (len(feature_shape) - 2)]
            protos[c] = p.reshape(-1)
    if dirichlet_label_skew > 0:
        pvals = rng.dirichlet(np.repeat(dirichlet_label_skew, num_classes))
        y = rng.choice(num_classes, size=n, p=pvals)
    else:
        y = rng.randint(0, num_classes, size=n)
    x = protos[y] + noise * rng.randn(n, dim).astype(np.float32)
    x = x.reshape((n,) + tuple(feature_shape)).astype(np.float32)
    return x, y.astype(np.int32)


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
