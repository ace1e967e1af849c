"""Parsers for locally cached real dataset files (no downloads).

The part of ``fedml_tpu/data/loaders.py`` that the ported slice reaches: the
LEAF json layout the next-word-prediction datasets are published in.  The
image, tabular and volume parsers are ported with the slices that train on
those datasets (ROADMAP.md queue A, item 2).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

LEAF_DATASETS = ("shakespeare", "fed_shakespeare", "stackoverflow_nwp", "stackoverflow_lr")


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


def try_load_real(name: str, cache_dir: str) -> Optional[Arrays]:
    """Real files for ``name`` under ``cache_dir`` (or its ``name``
    subdirectory), else None and the caller falls back to synthetic data."""
    if not cache_dir or not os.path.isdir(cache_dir):
        return None
    if name not in LEAF_DATASETS:
        raise NotImplementedError(
            f"no parser for cached {name!r} files in the port yet "
            "(ROADMAP.md queue A, item 2)")
    for root in (os.path.join(cache_dir, name), cache_dir):
        if os.path.isdir(root):
            out = load_leaf_json(root)
            if out is not None:
                return out
    return None
