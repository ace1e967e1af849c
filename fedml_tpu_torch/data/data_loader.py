"""Federated data loading of the port: ``load(args)`` -> (dataset, class_num).

A copy of ``fedml_tpu/data/data_loader.py`` that gives bit-identical numpy
arrays and partition maps for the same config.  It returns the same 8-tuple::

    [train_data_num, test_data_num, train_data_global, test_data_global,
     train_data_local_num_dict, train_data_local_dict, test_data_local_dict,
     class_num]

Data stay numpy ``(x, y)`` pairs; the simulator moves them to the device
once (simulation/xla/fed_sim.py ``_pack_data``).  The whole dataset table is
kept so names and class counts agree with the JAX package, but only the
next-word-prediction, image and ``feature`` kinds (the tabular rows of
``synthetic``, ``uci`` and ``lending_club``, from the image kind's
generator, as in the JAX package), the FedNLP family's (``seqcls``,
``seqtag``, ``span``, ``s2s``, and ``taglr``, the projected bag of words of
tag prediction), the FedGraphNN family's (``graph``, ``linkpred``,
``mtl_graph``, ``nodeclf``, ``graphreg``) and the vision tasks'
(``segmentation``: [H, W] int masks; ``detection``: [5] float labels, class
then box) and the IoT kind (``recon``: a benign-only train split whose
targets are its inputs, a test split with 0/1 anomaly flags) are ported:
every kind of the table.  Images stay NHWC, as in the JAX package;
the model's entry is the one place their layout changes.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Tuple

import numpy as np

from ..core.data.noniid_partition import (
    homo_partition,
    non_iid_partition_with_dirichlet_distribution,
    quantity_skew_partition,
)
from . import loaders, synthetic

logger = logging.getLogger(__name__)

# dataset key -> (num_classes, feature_shape, default train/test sizes, kind)
DATASET_SPECS: Dict[str, Dict[str, Any]] = {
    "mnist": dict(classes=10, shape=(28, 28, 1), train=60000, test=10000, kind="image"),
    "femnist": dict(classes=62, shape=(28, 28, 1), train=80000, test=10000, kind="image"),
    "fashionmnist": dict(classes=10, shape=(28, 28, 1), train=60000, test=10000, kind="image"),
    "cifar10": dict(classes=10, shape=(32, 32, 3), train=50000, test=10000, kind="image"),
    "cifar100": dict(classes=100, shape=(32, 32, 3), train=50000, test=10000, kind="image"),
    "fed_cifar100": dict(classes=100, shape=(32, 32, 3), train=50000, test=10000, kind="image"),
    "cinic10": dict(classes=10, shape=(32, 32, 3), train=90000, test=90000, kind="image"),
    "shakespeare": dict(classes=90, shape=(80,), train=40000, test=4000, kind="nwp", vocab=90),
    "fed_shakespeare": dict(classes=90, shape=(80,), train=40000, test=4000, kind="nwp", vocab=90),
    "stackoverflow_nwp": dict(classes=10004, shape=(20,), train=50000, test=5000, kind="nwp", vocab=10004),
    "stackoverflow_lr": dict(classes=500, shape=(10004,), train=50000, test=5000, kind="taglr"),
    "synthetic": dict(classes=10, shape=(60,), train=9600, test=2400, kind="feature"),
    "synthetic_1_1": dict(classes=10, shape=(60,), train=9600, test=2400, kind="feature"),
    # segmentation (FedSeg; reference uses pascal_voc/coco — synthetic fallback
    # keeps 3 shape classes at 32x32 for practical FL round sizes)
    "synthetic_seg": dict(classes=3, shape=(32, 32, 3), train=2000, test=400, kind="segmentation"),
    "pascal_voc": dict(classes=3, shape=(32, 32, 3), train=2000, test=400, kind="segmentation"),
    # fednlp text classification (reference app/fednlp: 20news/agnews/sst_2)
    "agnews": dict(classes=4, shape=(64,), train=12000, test=2000, kind="seqcls", vocab=2000),
    "sst_2": dict(classes=2, shape=(32,), train=8000, test=1000, kind="seqcls", vocab=2000),
    "20news": dict(classes=20, shape=(128,), train=11000, test=2000, kind="seqcls", vocab=4000),
    # fedgraphnn (reference app/fedgraphnn: moleculenet graph classification)
    "synthetic_graph": dict(classes=4, shape=(16, 24), train=2000, test=400, kind="graph",
                            num_nodes=16, feat_dim=8),
    "sider": dict(classes=4, shape=(16, 24), train=1400, test=300, kind="graph",
                  num_nodes=16, feat_dim=8),
    "clintox": dict(classes=2, shape=(16, 24), train=1400, test=300, kind="graph",
                    num_nodes=16, feat_dim=8),
    # healthcare / tabular (reference data: UCI, lending_club, FeTS)
    "uci": dict(classes=2, shape=(32,), train=8000, test=1600, kind="feature"),
    "lending_club": dict(classes=2, shape=(90,), train=10000, test=2000, kind="feature"),
    "fets2021": dict(classes=3, shape=(32, 32, 3), train=1000, test=200, kind="segmentation"),
    # ImageNet family (reference data/ImageNet; downsampled 32px variant for
    # TPU-static shapes — mounted train/val wnid folders parse via loaders)
    "imagenet": dict(classes=1000, shape=(32, 32, 3), train=20000, test=4000, kind="image"),
    "ilsvrc2012": dict(classes=1000, shape=(32, 32, 3), train=20000, test=4000, kind="image"),
    "tiny_imagenet": dict(classes=200, shape=(32, 32, 3), train=20000, test=4000, kind="image"),
    # Google Landmarks federated splits (reference data/Landmarks)
    "gld23k": dict(classes=203, shape=(32, 32, 3), train=23080, test=1959, kind="image"),
    "gld160k": dict(classes=2028, shape=(32, 32, 3), train=40000, test=4000, kind="image"),
    # NUS-WIDE multi-label low-level features (reference data/NUS_WIDE,
    # the vertical-FL dataset: 634-dim concatenated feature blocks, top-5 labels)
    "nuswide": dict(classes=5, shape=(634,), train=20000, test=4000, kind="taglr"),
    # IoT anomaly detection (reference iot/anomaly_detection_for_cybersecurity,
    # N-BaIoT-style benign-traffic autoencoder; classes = benign/anomaly)
    "iot_anomaly": dict(classes=2, shape=(24,), train=8000, test=1600, kind="recon",
                        anomaly_frac=0.1),
    "nbaiot": dict(classes=2, shape=(115,), train=8000, test=1600, kind="recon",
                   anomaly_frac=0.1),
    # fednlp sequence tagging / span extraction (reference app/fednlp
    # seq_tagging + span_extraction; synthetic corpora share the shapes)
    "onto_tagging": dict(classes=8, shape=(32,), train=8000, test=1600, kind="seqtag", vocab=2000),
    "wikiner": dict(classes=5, shape=(48,), train=8000, test=1600, kind="seqtag", vocab=2000),
    "squad_span": dict(classes=64, shape=(64,), train=8000, test=1600, kind="span", vocab=200),
    # fedcv object detection (reference app/fedcv/object_detection)
    "synthetic_det": dict(classes=6, shape=(32, 32, 3), train=4000, test=800, kind="detection"),
    "coco_det": dict(classes=6, shape=(32, 32, 3), train=4000, test=800, kind="detection"),
    # fednlp seq2seq (reference app/fednlp/seq2seq: CornellMovieDialogue);
    # classes = vocab (the LM head width over the packed sequence)
    "synthetic_s2s": dict(classes=64, shape=(24,), train=8000, test=1600, kind="s2s",
                          vocab=64, src_len=12, tgt_len=12),
    "cornell_movie_dialogue": dict(classes=64, shape=(24,), train=8000, test=1600, kind="s2s",
                                   vocab=64, src_len=12, tgt_len=12),
    # fedgraphnn link prediction (reference app/fedgraphnn
    # ego_networks_link_pred + recsys_subgraph_link_pred)
    "ego_linkpred": dict(classes=2, shape=(16, 24), train=2000, test=400, kind="linkpred",
                         num_nodes=16, feat_dim=8),
    "recsys_linkpred": dict(classes=2, shape=(16, 24), train=2000, test=400, kind="linkpred",
                            num_nodes=16, feat_dim=8, bipartite=True),
    # multi-task molecular property prediction with partial labels
    # (reference research/SpreadGNN; moleculenet sider/tox21 masks)
    "moleculenet_mtl": dict(classes=8, shape=(16, 24), train=2000, test=400, kind="mtl_graph",
                            num_nodes=16, feat_dim=8, num_tasks=8),
    # fedgraphnn node classification + graph regression (reference
    # app/fedgraphnn/{ego_networks_node_clf,moleculenet_graph_reg})
    "ego_nodeclf": dict(classes=3, shape=(16, 24), train=2000, test=400, kind="nodeclf",
                        num_nodes=16, feat_dim=8),
    "freesolv": dict(classes=1, shape=(16, 24), train=2000, test=400, kind="graphreg",
                     num_nodes=16, feat_dim=8),
    "esol": dict(classes=1, shape=(16, 24), train=2000, test=400, kind="graphreg",
                 num_nodes=16, feat_dim=8),
    "lipophilicity": dict(classes=1, shape=(16, 24), train=2000, test=400, kind="graphreg",
                          num_nodes=16, feat_dim=8),
}


def _generate(spec: Dict[str, Any], n: int, seed: int, scale_override: int = 0,
              proto_seed: int = 0, is_test: bool = False):
    kind = spec["kind"]
    n = int(scale_override or n)
    if kind == "recon":
        # benign-only train split (targets = inputs); the test split carries
        # injected anomalies with 0/1 flags (the IoT detection setup)
        x, flags = synthetic.make_iot_traffic(
            n, int(spec["shape"][0]), seed=seed, proto_seed=proto_seed,
            anomaly_frac=float(spec.get("anomaly_frac", 0.1)) if is_test else 0.0,
        )
        return (x, flags) if is_test else (x, x.copy())
    if kind in ("image", "feature"):
        return synthetic.make_classification(
            n, spec["classes"], tuple(spec["shape"]), seed=seed, proto_seed=proto_seed
        )
    if kind == "nwp":
        return synthetic.make_next_token_corpus(
            n, int(spec["shape"][0]), spec["vocab"], seed=seed, proto_seed=proto_seed
        )
    if kind == "segmentation":
        return synthetic.make_segmentation(
            n, tuple(spec["shape"][:2]), seed=seed, proto_seed=proto_seed
        )
    if kind == "seqcls":
        # class->vocab-band mapping is deterministic, so train/test share the
        # distribution without a proto_seed
        return synthetic.make_sequence_classification(
            n, spec["classes"], int(spec["shape"][0]), spec["vocab"], seed=seed
        )
    if kind == "graph":
        return synthetic.make_graph_classification(
            n, spec["num_nodes"], spec["feat_dim"], spec["classes"],
            seed=seed, proto_seed=proto_seed,
        )
    if kind == "seqtag":
        return synthetic.make_sequence_tagging(
            n, spec["classes"], int(spec["shape"][0]), spec["vocab"], seed=seed
        )
    if kind == "span":
        return synthetic.make_span_extraction(
            n, int(spec["shape"][0]), spec["vocab"], seed=seed
        )
    if kind == "detection":
        return synthetic.make_detection(
            n, tuple(spec["shape"][:2]), spec["classes"], seed=seed
        )
    if kind == "s2s":
        return synthetic.make_seq2seq(
            n, spec["src_len"], spec["tgt_len"], spec["vocab"], seed=seed
        )
    if kind == "linkpred":
        return synthetic.make_link_prediction(
            n, spec["num_nodes"], spec["feat_dim"], seed=seed,
            bipartite=bool(spec.get("bipartite", False)), proto_seed=proto_seed,
        )
    if kind == "mtl_graph":
        return synthetic.make_multitask_graphs(
            n, spec["num_nodes"], spec["feat_dim"], spec["num_tasks"],
            seed=seed, proto_seed=proto_seed,
        )
    if kind == "nodeclf":
        return synthetic.make_node_classification(
            n, spec["num_nodes"], spec["feat_dim"], spec["classes"],
            seed=seed, proto_seed=proto_seed,
        )
    if kind == "graphreg":
        return synthetic.make_graph_regression(
            n, spec["num_nodes"], spec["feat_dim"], seed=seed, proto_seed=proto_seed,
        )
    if kind == "taglr":
        x, y = synthetic.make_classification(
            n, spec["classes"], (64,), seed=seed, proto_seed=proto_seed
        )
        # sparse bag-of-words style expansion; projection is part of the
        # "distribution" so it derives from proto_seed (shared train/test)
        rngl = np.random.RandomState(proto_seed + 1)
        proj = rngl.randn(64, spec["shape"][0]).astype(np.float32)
        return (x @ proj > 1.0).astype(np.float32), y
    raise ValueError(kind)


def load_centralized(args) -> Dict[str, Any]:
    """-> dict(x_train, y_train, x_test, y_test, class_num, input_shape)."""
    name = str(getattr(args, "dataset", "mnist")).lower()
    if name not in DATASET_SPECS:
        raise ValueError(f"unknown dataset {name!r}; known: {sorted(DATASET_SPECS)}")
    spec = DATASET_SPECS[name]
    cache = getattr(args, "data_cache_dir", None)
    seed = int(getattr(args, "random_seed", 0))
    real = loaders.try_load_real(name, cache) if cache else None
    # the hub sizes first layers from real files' samples, which need not
    # have the spec's shape (models/hub.py _in_shape)
    args.data_input_shape = None
    if real is not None:
        x_train, y_train, x_test, y_test = real
        args.dataset_is_synthetic = False
        args.data_input_shape = tuple(x_train.shape[1:])
        logger.info("loaded real %s from %s", name, cache)
    else:
        scale = int(getattr(args, "synthetic_train_size", 0))
        x_train, y_train = _generate(spec, spec["train"], seed, scale, proto_seed=seed)
        x_test, y_test = _generate(
            spec, spec["test"], seed + 10_000, scale // 5 if scale else 0,
            proto_seed=seed, is_test=True,
        )
        args.dataset_is_synthetic = True
        logger.info("generated synthetic %s (no cached files under %r)", name, cache)
    return dict(
        x_train=x_train,
        y_train=y_train,
        x_test=x_test,
        y_test=y_test,
        class_num=spec["classes"],
        input_shape=tuple(x_train.shape[1:]),
    )


def load(args) -> Tuple[list, int]:
    """Reference-shaped federated load (same partitions as the JAX package)."""
    data = load_centralized(args)
    client_num = int(getattr(args, "client_num_in_total", 1))
    method = str(getattr(args, "partition_method", "hetero")).lower()
    alpha = float(getattr(args, "partition_alpha", 0.5))
    seed = int(getattr(args, "random_seed", 0))
    y_train, y_test = data["y_train"], data["y_test"]

    if method in ("hetero", "noniid", "dirichlet"):
        name = str(getattr(args, "dataset", "mnist")).lower()
        kind = DATASET_SPECS.get(name, {}).get("kind")
        num_buckets = data["class_num"]
        if y_train.ndim == 1:
            part_labels = y_train
        elif kind == "detection":
            part_labels = y_train[:, 0].astype(int)  # object class column
        elif kind == "segmentation":
            # dominant FOREGROUND class per image: a mask-mean bucket would
            # put ~every image in bucket 0 (background majority) and the
            # Dirichlet split would degenerate to quantity-only
            flat = y_train.reshape(len(y_train), -1)
            counts = np.stack(
                [(flat == c).sum(axis=1) for c in range(data["class_num"])], axis=1
            )
            fg = counts[:, 1:]
            part_labels = np.where(fg.max(axis=1) > 0, fg.argmax(axis=1) + 1, 0)
        elif kind == "graphreg":
            # continuous target: quartile-bin the property so the Dirichlet
            # split skews by target range (class_num is 1 for regression)
            t = y_train.reshape(len(y_train), -1)[:, 0]
            part_labels = np.digitize(t, np.quantile(t, [0.25, 0.5, 0.75]))
            num_buckets = 4
        elif kind in ("linkpred", "mtl_graph"):
            # labels carry -1 sentinels; bucket by positive-label count
            # (graph density / task profile), clipped to the class range
            pos = (y_train.reshape(len(y_train), -1) > 0).sum(axis=1)
            if kind == "linkpred":
                pos //= 2  # symmetric pairs: raw counts are always even
            part_labels = (pos % data["class_num"]).astype(int)
        elif kind == "s2s":
            # bucket by mean target token (ignore the -1 source positions)
            flat = y_train.reshape(len(y_train), -1)
            valid = flat >= 0
            mean_tok = (flat * valid).sum(axis=1) / np.maximum(valid.sum(axis=1), 1)
            part_labels = (mean_tok % data["class_num"]).astype(int)
        else:
            # NWP labels are sequences; bucket by sequence-mean token
            part_labels = (
                y_train.reshape(len(y_train), -1).mean(axis=1) % data["class_num"]
            ).astype(int)
        train_map = non_iid_partition_with_dirichlet_distribution(
            part_labels, client_num, num_buckets, alpha, seed=seed
        )
    elif method in ("homo", "iid"):
        train_map = homo_partition(len(y_train), client_num, seed=seed)
    elif method == "quantity_skew":
        train_map = quantity_skew_partition(len(y_train), client_num, alpha, seed=seed)
    else:
        raise ValueError(f"unknown partition_method {method!r}")
    test_map = homo_partition(len(y_test), client_num, seed=seed + 1)

    x_train, x_test = data["x_train"], data["x_test"]
    train_data_local_dict = {}
    test_data_local_dict = {}
    train_data_local_num_dict = {}
    for i in range(client_num):
        tr_idx, te_idx = train_map[i], test_map[i]
        train_data_local_dict[i] = (x_train[tr_idx], y_train[tr_idx])
        test_data_local_dict[i] = (x_test[te_idx], y_test[te_idx])
        train_data_local_num_dict[i] = int(len(tr_idx))

    dataset = [
        len(y_train),
        len(y_test),
        (x_train, y_train),
        (x_test, y_test),
        train_data_local_num_dict,
        train_data_local_dict,
        test_data_local_dict,
        data["class_num"],
    ]
    return dataset, data["class_num"]
