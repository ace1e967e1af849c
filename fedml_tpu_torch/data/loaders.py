"""Parsers for locally cached real dataset files (no downloads).

The part of ``fedml_tpu/data/loaders.py`` that the ported slices reach: the
LEAF json layout the next-word-prediction datasets are published in, the
CIFAR python pickles, and the edge-case example pools of the edge-case
backdoor.  The other image, tabular and volume parsers are
ported with the slices that train on those datasets (ROADMAP.md queue A,
item 3: data, the rest).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

LEAF_DATASETS = ("shakespeare", "fed_shakespeare", "stackoverflow_nwp", "stackoverflow_lr")
CIFAR_DATASETS = ("cifar10", "cifar100", "fed_cifar100")


def load_leaf_json(root: str) -> Optional[Arrays]:
    """LEAF format: train/*.json + test/*.json with users/user_data."""
    tr_dir, te_dir = os.path.join(root, "train"), os.path.join(root, "test")
    if not (os.path.isdir(tr_dir) and os.path.isdir(te_dir)):
        return None

    def _collect(d):
        xs, ys = [], []
        for fn in sorted(os.listdir(d)):
            if not fn.endswith(".json"):
                continue
            with open(os.path.join(d, fn)) as f:
                blob = json.load(f)
            for u in blob.get("users", []):
                ud = blob["user_data"][u]
                xs.append(np.asarray(ud["x"], dtype=np.float32))
                ys.append(np.asarray(ud["y"], dtype=np.int32))
        if not xs:
            return None
        return np.concatenate(xs, 0), np.concatenate(ys, 0)

    tr = _collect(tr_dir)
    te = _collect(te_dir)
    if tr is None or te is None:
        return None
    xt, yt = tr
    xe, ye = te
    if xt.ndim == 2 and xt.shape[1] == 784:
        xt = xt.reshape(-1, 28, 28, 1)
        xe = xe.reshape(-1, 28, 28, 1)
    return xt, yt, xe, ye


def load_cifar_pickle(root: str) -> Optional[Arrays]:
    """The CIFAR-10/100 python release (``data_batch_*``/``test_batch`` or
    ``train``/``test`` pickles) -> NHWC float32 in [0, 1], int32 labels (the
    fine labels of CIFAR-100)."""
    batches = []
    test = None
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.startswith("data_batch") or f in ("train",):
                batches.append(os.path.join(dirpath, f))
            elif f in ("test_batch", "test"):
                test = os.path.join(dirpath, f)
    if not batches or test is None:
        return None

    def _load(path):
        with open(path, "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
        key = b"fine_labels" if b"fine_labels" in d else b"labels"
        y = np.asarray(d[key], dtype=np.int32)
        return x, y

    xs, ys = zip(*[_load(b) for b in sorted(batches)])
    xt, yt = np.concatenate(xs), np.concatenate(ys)
    xe, ye = _load(test)
    return xt, yt, xe, ye


def try_load_real(name: str, cache_dir: str) -> Optional[Arrays]:
    """Real files for ``name`` under ``cache_dir`` (or its ``name``
    subdirectory), else None and the caller falls back to synthetic data."""
    if not cache_dir or not os.path.isdir(cache_dir):
        return None
    if name in LEAF_DATASETS:
        parse = load_leaf_json
    elif name in CIFAR_DATASETS:
        parse = load_cifar_pickle
    else:
        raise NotImplementedError(
            f"no parser for cached {name!r} files in the port yet "
            "(ROADMAP.md queue A, item 3: data, the rest)")
    for root in (os.path.join(cache_dir, name), cache_dir):
        if os.path.isdir(root):
            out = parse(root)
            if out is not None:
                return out
    return None


def load_edge_case_pool(root: str) -> Optional[dict]:
    """Edge-case backdoor example pools (reference
    ``data/edge_case_examples/data_loader.py``: ARDIS '7's for MNIST,
    Southwest airliners for CIFAR — pickles of image arrays).  Accepts any
    ``*.pkl`` under ``root`` holding an ndarray [N, ...] or a dict with a
    'data' entry.  A mounted dir typically mixes sample shapes (MNIST-shaped
    ARDIS next to CIFAR-shaped Southwest), so pools are grouped BY SAMPLE
    SHAPE: returns ``{sample_shape_tuple: float_images_in_[0,1]}``."""
    import glob as _glob

    groups: dict = {}
    for p in sorted(_glob.glob(os.path.join(root, "*.pkl"))):
        try:
            with open(p, "rb") as f:
                obj = pickle.load(f)
        except Exception:
            continue
        if isinstance(obj, dict):
            obj = obj.get("data")
        arr = np.asarray(obj)
        if arr.ndim >= 2 and len(arr):
            arr = arr.astype(np.float32)
            if arr.max() > 1.5:  # uint8-coded images
                arr = arr / 255.0
            groups.setdefault(tuple(arr.shape[1:]), []).append(arr)
    if not groups:
        return None
    return {shape: np.concatenate(pools, axis=0) for shape, pools in groups.items()}
