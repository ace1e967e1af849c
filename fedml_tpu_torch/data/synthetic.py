"""Synthetic stand-in corpora (numpy only), copied from
``fedml_tpu/data/synthetic.py`` so the port draws bit-identical arrays from
the same seeds.  Only the generators the ported slices need are here: the
class-prototype images and features (``make_classification``), the
next-word-prediction corpus, and the FedNLP task family's corpora (sequence
classification, tagging, span extraction, seq2seq)."""

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


def make_sequence_classification(
    n: int, num_classes: int, seq_len: int, vocab_size: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Token sequences whose class is recoverable from token statistics."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    # each class favors a band of the vocabulary
    band = vocab_size // max(num_classes, 1)
    x = np.empty((n, seq_len), dtype=np.int32)
    for i in range(n):
        lo = y[i] * band
        favored = rng.randint(lo, max(lo + band, lo + 1), size=seq_len)
        uniform = rng.randint(0, vocab_size, size=seq_len)
        pick = rng.rand(seq_len) < 0.6
        x[i] = np.where(pick, favored, uniform)
    return x, y


def make_sequence_tagging(
    n: int, num_tags: int, seq_len: int, vocab_size: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token tagging corpus: each token's tag is its vocabulary band
    (NER/POS-shaped — reference app/fednlp/seq_tagging).  x [n, L] int32,
    y [n, L] int32 in [0, num_tags)."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, vocab_size, size=(n, seq_len)).astype(np.int32)
    band = max(vocab_size // max(num_tags, 1), 1)
    y = np.minimum(x // band, num_tags - 1).astype(np.int32)
    # tag noise: a small fraction of tokens carry a random tag so the task
    # is not trivially 100% learnable
    flip = rng.rand(n, seq_len) < 0.05
    y = np.where(flip, rng.randint(0, num_tags, size=(n, seq_len)), y).astype(np.int32)
    return x, y


def make_span_extraction(
    n: int, seq_len: int, vocab_size: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Span-extraction corpus (SQuAD-shaped — reference
    app/fednlp/span_extraction): the answer is a contiguous run of tokens
    from a distinct vocabulary band ([2, 50) vs context [60, vocab)), so the
    extraction RULE is generalizable; y [n, 2] = (start, end) indices.
    (A pure marker-bracket design lets a memorizing net hit zero held-out
    exact-match — band coding keeps the task rule-learnable at CI scale.)"""
    rng = np.random.RandomState(seed)
    x = rng.randint(60, max(vocab_size, 61), size=(n, seq_len)).astype(np.int32)
    y = np.zeros((n, 2), np.int32)
    for i in range(n):
        start = rng.randint(1, seq_len - 4)
        end = min(start + rng.randint(1, 5), seq_len - 2)
        x[i, start:end + 1] = rng.randint(2, 50, size=end - start + 1)
        y[i] = (start, end)
    return x, y


def make_seq2seq(
    n: int, src_len: int, tgt_len: int, vocab_size: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Seq2seq corpus packed for a causal decoder-only LM (the TPU-first
    redesign of reference app/fednlp/seq2seq's encoder-decoder BART: one
    causal stack over [src ‖ SEP ‖ tgt] with loss masked to target positions
    — same task contract, no cross-attention module to shard).

    Task: emit each source token's successor in vocab order (tgt[j] =
    succ(src[j]) — a constant relative-offset attention pattern plus a
    learned token mapping, the right-sized learnability gate for a RoPE
    causal stack; reversal's varying offsets need far more steps than a CI
    smoke test allows).  x [n, L] int32 with L = src_len + tgt_len: src
    tokens in [2, vocab), SEP = 1, then the teacher-forced target prefix.
    y [n, L] int32: -1 on source positions, target token ids elsewhere
    (engine loss kind "s2s")."""
    rng = np.random.RandomState(seed)
    L = src_len + tgt_len
    x = np.zeros((n, L), np.int32)
    y = np.full((n, L), -1, np.int32)
    src = rng.randint(2, max(vocab_size, 3), size=(n, src_len)).astype(np.int32)
    tgt = (2 + (src - 2 + 1) % (vocab_size - 2)).astype(np.int32)
    x[:, :src_len] = src
    x[:, src_len] = 1  # SEP starts decoding
    x[:, src_len + 1 :] = tgt[:, : tgt_len - 1]
    y[:, src_len:] = tgt
    return x, y
