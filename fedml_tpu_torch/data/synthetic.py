"""Synthetic stand-in corpora (numpy only), copied from
``fedml_tpu/data/synthetic.py`` so the port draws bit-identical arrays from
the same seeds.  Only the generators the ported slices need are here: the
class-prototype images and features (``make_classification``), the
next-word-prediction corpus, the FedNLP task family's corpora (sequence
classification, tagging, span extraction, seq2seq), the FedGraphNN
family's graphs (graph classification, link prediction, multi-task, node
classification, graph regression), each packed ``[n, N, F+N]`` (node
features ‖ dense adjacency), the vision tasks' segmentation pairs and
single-object detection images, and the IoT anomaly-detection traffic."""

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


def make_graph_classification(
    n: int, num_nodes: int = 16, feat_dim: int = 8, num_classes: int = 4,
    seed: int = 0, proto_seed: int = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic graph-classification set packed as [n, N, F+N] (node
    features ‖ dense adjacency — the layout models/gcn.py consumes).  Class
    signal: per-class node-feature prototypes AND class-dependent edge
    density, so both the feature and the structure path of a GNN carry
    information."""
    rng = np.random.RandomState(seed)
    proto_rng = np.random.RandomState(seed if proto_seed is None else proto_seed)
    protos = proto_rng.randn(num_classes, feat_dim).astype(np.float32)
    densities = np.linspace(0.15, 0.6, num_classes)
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    x = np.zeros((n, num_nodes, feat_dim + num_nodes), np.float32)
    for i in range(n):
        c = y[i]
        n_real = rng.randint(max(num_nodes // 2, 2), num_nodes + 1)
        feats = protos[c] + 0.5 * rng.randn(n_real, feat_dim)
        upper = rng.rand(n_real, n_real) < densities[c]
        adj = np.triu(upper, 1)
        adj = (adj | adj.T).astype(np.float32)
        x[i, :n_real, :feat_dim] = feats
        x[i, :n_real, feat_dim : feat_dim + n_real] = adj
    return x, y


def make_link_prediction(
    n: int, num_nodes: int = 16, feat_dim: int = 8, seed: int = 0,
    bipartite: bool = False, holdout: float = 0.3, proto_seed: int = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Link-prediction subgraphs (reference app/fedgraphnn
    ego_networks_link_pred; ``bipartite=True`` is the recsys
    user-item variant, recsys_subgraph_link_pred).

    Each sample: nodes carry a latent community (or user-group/item-category
    when bipartite); edges form mostly within-community (across matching
    user-group/item-category pairs when bipartite).  A ``holdout`` fraction
    of true edges is removed from the observed adjacency and becomes the
    positive labels; an equal number of true non-edges becomes the
    negatives.  x [n, N, F+N] (features ‖ observed adjacency, the gcn.py
    packing); y [n, N, N] f32 in {-1, 0, 1} (engine loss kind "linkpred")."""
    rng = np.random.RandomState(seed)
    prng = np.random.RandomState((seed if proto_seed is None else proto_seed) + 77)
    protos = prng.randn(2, feat_dim).astype(np.float32)
    x = np.zeros((n, num_nodes, feat_dim + num_nodes), np.float32)
    y = np.full((n, num_nodes, num_nodes), -1.0, np.float32)
    half = num_nodes // 2
    for i in range(n):
        if bipartite:
            # nodes [0, half) = users, [half, N) = items; community = group
            comm = np.concatenate([rng.randint(0, 2, half), rng.randint(0, 2, num_nodes - half)])
            is_user = np.arange(num_nodes) < half
            cross = is_user[:, None] != is_user[None, :]
            p_edge = np.where(comm[:, None] == comm[None, :], 0.8, 0.05) * cross
        else:
            comm = rng.randint(0, 2, num_nodes)
            p_edge = np.where(comm[:, None] == comm[None, :], 0.7, 0.05)
        feats = protos[comm] + 0.4 * rng.randn(num_nodes, feat_dim)
        upper = np.triu(rng.rand(num_nodes, num_nodes) < p_edge, 1)
        true_adj = (upper | upper.T)
        # hold out a fraction of true edges as positive labels
        iu, ju = np.nonzero(np.triu(true_adj, 1))
        if len(iu) == 0:
            x[i, :, :feat_dim] = feats
            continue
        k = max(1, int(holdout * len(iu)))
        pick = rng.choice(len(iu), size=k, replace=False)
        obs = true_adj.copy()
        obs[iu[pick], ju[pick]] = obs[ju[pick], iu[pick]] = False
        # negatives: sample k true non-edges (off-diagonal)
        neg_mask = ~true_adj & ~np.eye(num_nodes, dtype=bool)
        if bipartite:
            neg_mask &= cross
        ni, nj = np.nonzero(np.triu(neg_mask, 1))
        npick = rng.choice(len(ni), size=min(k, len(ni)), replace=False)
        y[i, iu[pick], ju[pick]] = y[i, ju[pick], iu[pick]] = 1.0
        y[i, ni[npick], nj[npick]] = y[i, nj[npick], ni[npick]] = 0.0
        x[i, :, :feat_dim] = feats
        x[i, :, feat_dim:] = obs.astype(np.float32)
    return x, y


def make_multitask_graphs(
    n: int, num_nodes: int = 16, feat_dim: int = 8, num_tasks: int = 8,
    seed: int = 0, proto_seed: int = None, label_frac: float = 0.7,
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-task molecular-property-style graphs with PARTIAL labels — the
    SpreadGNN setting (reference research/SpreadGNN; moleculenet sider/tox21
    carry per-task label masks).  Each graph has a latent prototype; task t's
    binary label is sign(w_t · prototype); each (graph, task) entry is
    observed with prob ``label_frac`` else -1.  x packed as [n, N, F+N]
    (gcn.py layout); y [n, T] f32 in {-1, 0, 1} (engine loss "mtl_bce")."""
    rng = np.random.RandomState(seed)
    prng = np.random.RandomState(seed if proto_seed is None else proto_seed)
    n_proto = 6
    protos = prng.randn(n_proto, feat_dim).astype(np.float32)
    task_w = prng.randn(num_tasks, feat_dim).astype(np.float32)
    x = np.zeros((n, num_nodes, feat_dim + num_nodes), np.float32)
    y = np.zeros((n, num_tasks), np.float32)
    densities = np.linspace(0.15, 0.6, n_proto)
    for i in range(n):
        c = rng.randint(0, n_proto)
        n_real = rng.randint(max(num_nodes // 2, 2), num_nodes + 1)
        feats = protos[c] + 0.4 * rng.randn(n_real, feat_dim)
        upper = rng.rand(n_real, n_real) < densities[c]
        adj = np.triu(upper, 1)
        adj = (adj | adj.T).astype(np.float32)
        x[i, :n_real, :feat_dim] = feats
        x[i, :n_real, feat_dim : feat_dim + n_real] = adj
        labels = (task_w @ protos[c] > 0).astype(np.float32)
        observed = rng.rand(num_tasks) < label_frac
        y[i] = np.where(observed, labels, -1.0)
    return x, y


def make_node_classification(
    n: int, num_nodes: int = 16, feat_dim: int = 8, num_classes: int = 3,
    seed: int = 0, proto_seed: int = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-node classification graphs (reference app/fedgraphnn
    ego_networks_node_clf): each node's class is its community; features
    carry the community prototype, edges form mostly within-community, so
    both feature and structure paths are informative.  x [n, N, F+N]
    (gcn.py packing); y [n, N] int32 node labels (padding nodes get 0 and
    are silenced by the model's node mask)."""
    rng = np.random.RandomState(seed)
    prng = np.random.RandomState((seed if proto_seed is None else proto_seed) + 53)
    protos = prng.randn(num_classes, feat_dim).astype(np.float32)
    x = np.zeros((n, num_nodes, feat_dim + num_nodes), np.float32)
    y = np.zeros((n, num_nodes), np.int32)
    for i in range(n):
        comm = rng.randint(0, num_classes, num_nodes)
        feats = protos[comm] + 0.5 * rng.randn(num_nodes, feat_dim)
        p_edge = np.where(comm[:, None] == comm[None, :], 0.5, 0.05)
        upper = np.triu(rng.rand(num_nodes, num_nodes) < p_edge, 1)
        adj = (upper | upper.T).astype(np.float32)
        x[i, :, :feat_dim] = feats
        x[i, :, feat_dim:] = adj
        y[i] = comm
    return x, y


def make_graph_regression(
    n: int, num_nodes: int = 16, feat_dim: int = 8, seed: int = 0,
    proto_seed: int = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Graph-level property regression (reference app/fedgraphnn
    moleculenet_graph_reg): target = w · mean-node-features + density term
    (both paths of a GNN carry signal).  y [n, 1] f32."""
    rng = np.random.RandomState(seed)
    prng = np.random.RandomState((seed if proto_seed is None else proto_seed) + 67)
    w = prng.randn(feat_dim).astype(np.float32)
    x = np.zeros((n, num_nodes, feat_dim + num_nodes), np.float32)
    y = np.zeros((n, 1), np.float32)
    for i in range(n):
        feats = rng.randn(num_nodes, feat_dim).astype(np.float32)
        density = rng.uniform(0.1, 0.6)
        upper = np.triu(rng.rand(num_nodes, num_nodes) < density, 1)
        adj = (upper | upper.T).astype(np.float32)
        x[i, :, :feat_dim] = feats
        x[i, :, feat_dim:] = adj
        y[i, 0] = feats.mean(axis=0) @ w + 2.0 * density
    return x, y


def make_segmentation(
    n: int, image_hw: Tuple[int, int] = (32, 32), seed: int = 0, proto_seed: int = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic segmentation pairs: images [n, H, W, 3] with a random circle
    (class 1) and/or rectangle (class 2) on textured background (class 0);
    masks [n, H, W] int32.  Shape-faithful stand-in for VOC/COCO-style data
    when no cache is mounted (FedSeg)."""
    h, w = image_hw
    rng = np.random.RandomState(seed)
    # the class "appearance" (object colors) is the distribution — it derives
    # from proto_seed so train and test share it (same contract as
    # make_classification's prototypes)
    proto_rng = np.random.RandomState(seed if proto_seed is None else proto_seed)
    circle_color = np.array([0.9, 0.2, 0.2]) + 0.05 * proto_rng.randn(3)
    rect_color = np.array([0.2, 0.2, 0.9]) + 0.05 * proto_rng.randn(3)
    x = rng.rand(n, h, w, 3).astype(np.float32) * 0.2
    masks = np.zeros((n, h, w), dtype=np.int32)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        if rng.rand() < 0.8:  # circle
            cy, cx = rng.randint(h // 4, 3 * h // 4), rng.randint(w // 4, 3 * w // 4)
            r = rng.randint(min(h, w) // 8, min(h, w) // 4)
            circ = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            masks[i][circ] = 1
            x[i][circ] = circle_color + 0.1 * rng.randn(3)
        if rng.rand() < 0.8:  # rectangle (drawn second: may occlude)
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            hh, ww = rng.randint(h // 6, h // 3), rng.randint(w // 6, w // 3)
            rect = np.zeros((h, w), bool)
            rect[y0 : y0 + hh, x0 : x0 + ww] = True
            masks[i][rect] = 2
            x[i][rect] = rect_color + 0.1 * rng.randn(3)
    return x, masks


def make_detection(
    n: int, hw: Tuple[int, int], num_classes: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Single-object detection set (reference app/fedcv/object_detection
    shape): one axis-aligned bright box per image, class = box color channel
    pattern.  x [n, H, W, 3] f32; y [n, 5] f32 = (class, cx, cy, w, h) with
    box coords normalized to [0, 1]."""
    rng = np.random.RandomState(seed)
    H, W = hw
    x = (rng.rand(n, H, W, 3) * 0.15).astype(np.float32)
    y = np.zeros((n, 5), np.float32)
    for i in range(n):
        cls = rng.randint(0, num_classes)
        bw = rng.randint(W // 6, W // 2)
        bh = rng.randint(H // 6, H // 2)
        x0 = rng.randint(0, W - bw)
        y0 = rng.randint(0, H - bh)
        patch = np.full((bh, bw, 3), 0.2, np.float32)
        patch[..., cls % 3] = 0.95  # class-dependent dominant channel
        if cls >= 3:  # second pattern axis: bright frame
            patch[0, :, :] = patch[-1, :, :] = patch[:, 0, :] = patch[:, -1, :] = 1.0
        x[i, y0:y0 + bh, x0:x0 + bw] = patch
        y[i] = (cls, (x0 + bw / 2) / W, (y0 + bh / 2) / H, bw / W, bh / H)
    return x, y


def make_iot_traffic(
    n: int, feat_dim: int = 24, seed: int = 0, proto_seed: int = None,
    anomaly_frac: float = 0.0, latent_dim: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """IoT network-traffic-shaped anomaly set (N-BaIoT style): benign rows
    lie on a low-rank manifold (latent z @ W + 0.05 noise) that an
    autoencoder can compress; anomalies (``anomaly_frac`` of the rows, at
    indices drawn without replacement) are uniform rows in [-4, 4].  W comes
    from ``RandomState(proto_seed + 31)`` (``seed`` when None), the rest
    from ``RandomState(seed)``.  Returns (x [n, F] f32, flags [n] int32 in
    {0, 1}); train splits use anomaly_frac=0 (benign only)."""
    rng = np.random.RandomState(seed)
    prng = np.random.RandomState((seed if proto_seed is None else proto_seed) + 31)
    w = prng.randn(latent_dim, feat_dim).astype(np.float32)
    z = rng.randn(n, latent_dim).astype(np.float32)
    x = z @ w + 0.05 * rng.randn(n, feat_dim).astype(np.float32)
    flags = np.zeros(n, np.int32)
    if anomaly_frac > 0:
        k = max(1, int(anomaly_frac * n))
        idx = rng.choice(n, size=k, replace=False)
        x[idx] = rng.uniform(-4.0, 4.0, size=(k, feat_dim)).astype(np.float32)
        flags[idx] = 1
    return x, flags
