"""Parsers for locally cached real dataset files (no downloads).

The part of ``fedml_tpu/data/loaders.py`` that the ported slices reach: the
LEAF json layout the next-word-prediction datasets (and femnist and
stackoverflow_lr) are published in, the CIFAR python pickles, the NUS-WIDE
multi-label features, the FeTS 2021 NIfTI volumes (read without nibabel:
the middle axial slice of each subject, resized), and the edge-case example
pools of the edge-case backdoor.  A dataset the JAX package has no parser for has no real files:
``try_load_real`` returns None and the caller generates synthetic data, as
in the JAX package.  The other image, tabular and volume parsers are ported
with the slices that train on those datasets (ROADMAP.md queue A, item 3:
data, the rest); their datasets raise while a cache directory exists.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

LEAF_DATASETS = ("femnist", "shakespeare", "fed_shakespeare", "stackoverflow_nwp",
                 "stackoverflow_lr")
CIFAR_DATASETS = ("cifar10", "cifar100", "fed_cifar100")
NUSWIDE_DATASETS = ("nuswide", "nus_wide")
FETS_DATASETS = ("fets2021",)
# the datasets whose JAX parser is not ported yet
_UNPORTED_PARSERS = ("mnist", "fashionmnist", "cinic10", "uci", "lending_club", "imagenet",
                     "ilsvrc2012", "tiny_imagenet", "gld23k", "gld160k", "landmarks")


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
    elif name in NUSWIDE_DATASETS:
        parse = load_nuswide
    elif name in FETS_DATASETS:
        parse = load_fets_nifti
    elif name in _UNPORTED_PARSERS:
        raise NotImplementedError(
            f"no parser for cached {name!r} files in the port yet "
            "(ROADMAP.md queue A, item 3: data, the rest)")
    else:
        return None  # no parser in the JAX package either
    for root in (os.path.join(cache_dir, name), cache_dir):
        if os.path.isdir(root):
            out = parse(root)
            if out is not None:
                return out
    return None


def load_nuswide(root: str, top_k: int = 5) -> Optional[Arrays]:
    """NUS-WIDE low-level-features + multi-label groundtruth (reference
    ``data/NUS_WIDE/nus_wide_dataset.py:8-60`` layout):
    ``Groundtruth/TrainTestLabels/Labels_<name>_<Train|Test>.txt`` (one 0/1
    per line) and ``Low_Level_Features/*_<Train|Test>_*.dat`` (whitespace-
    separated floats per line, concatenated feature blocks).  A full mount
    has 81 concept files; like the reference's ``get_top_k_labels`` the
    ``top_k`` most frequent (by train positives) are kept so label width
    matches the registered spec.  Returns multi-hot y [N, top_k]."""
    import glob as _glob

    lab_dir = os.path.join(root, "Groundtruth", "TrainTestLabels")
    feat_dir = os.path.join(root, "Low_Level_Features")
    if not (os.path.isdir(lab_dir) and os.path.isdir(feat_dir)):
        return None
    names = sorted(
        os.path.basename(p)[len("Labels_"):-len("_Train.txt")]
        for p in _glob.glob(os.path.join(lab_dir, "Labels_*_Train.txt"))
    )
    if not names:
        return None
    if len(names) > top_k:
        counts = {}
        for nm in names:
            try:
                counts[nm] = float(
                    np.loadtxt(os.path.join(lab_dir, f"Labels_{nm}_Train.txt")).sum()
                )
            except (OSError, ValueError):
                counts[nm] = -1.0
        names = sorted(sorted(counts, key=counts.get, reverse=True)[:top_k])

    def _labels(dtype):
        cols = []
        for nm in names:
            p = os.path.join(lab_dir, f"Labels_{nm}_{dtype}.txt")
            if not os.path.isfile(p):
                return None
            cols.append(np.loadtxt(p, dtype=np.float32).reshape(-1))
        return np.stack(cols, axis=1)

    def _feats(dtype):
        blocks = []
        for p in sorted(_glob.glob(os.path.join(feat_dir, f"*_{dtype}_*.dat"))):
            blocks.append(np.loadtxt(p, dtype=np.float32, ndmin=2))
        if not blocks:
            return None
        return np.concatenate(blocks, axis=1)

    xt, yt = _feats("Train"), _labels("Train")
    xe, ye = _feats("Test"), _labels("Test")
    if any(v is None for v in (xt, yt, xe, ye)):
        return None
    n_tr, n_te = min(len(xt), len(yt)), min(len(xe), len(ye))
    return xt[:n_tr], yt[:n_tr], xe[:n_te], ye[:n_te]


# -- FeTS 2021 (medical segmentation, NIfTI volumes) ------------------------

_NIFTI_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
                 64: np.float64, 256: np.int8, 512: np.uint16}


def _read_nifti(path: str) -> Optional[np.ndarray]:
    """Minimal little-endian NIfTI-1 reader (no nibabel in the image):
    348-byte header — dim[8] @40, datatype @70, vox_offset @108; data is
    Fortran-ordered."""
    import gzip
    import struct

    op = gzip.open if path.endswith(".gz") else open
    try:
        with op(path, "rb") as f:
            buf = f.read()
    except (OSError, EOFError, gzip.BadGzipFile):
        return None  # corrupt/truncated volume: skip subject, don't abort load
    if len(buf) < 352 or struct.unpack_from("<i", buf, 0)[0] != 348:
        return None
    dim = struct.unpack_from("<8h", buf, 40)
    ndim = max(1, min(dim[0], 7))
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    dt = _NIFTI_DTYPES.get(struct.unpack_from("<h", buf, 70)[0])
    if dt is None or any(s <= 0 for s in shape):
        return None
    vox = int(struct.unpack_from("<f", buf, 108)[0]) or 352
    n = int(np.prod(shape))
    if vox + n * np.dtype(dt).itemsize > len(buf):
        return None  # truncated data section
    arr = np.frombuffer(buf, dtype=dt, offset=vox, count=n)
    return arr.reshape(shape, order="F")


def _mid_slice_resized(vol: np.ndarray, size: int) -> np.ndarray:
    """Middle axial slice, nearest-neighbor resized to [size, size]."""
    sl = vol[:, :, vol.shape[2] // 2] if vol.ndim >= 3 else vol
    sl = np.asarray(sl, np.float32)
    iy = np.linspace(0, sl.shape[0] - 1, size).astype(int)
    ix = np.linspace(0, sl.shape[1] - 1, size).astype(int)
    return sl[np.ix_(iy, ix)]


def load_fets_nifti(root: str, size: int = 32) -> Optional[Arrays]:
    """FeTS 2021 (reference ``data/FeTS2021``; BraTS per-subject layout):
    ``<subject>/<subject>_{t1,t1ce,t2,flair}.nii[.gz]`` + ``_seg``.  Takes
    the middle axial slice, stacks 3 modalities as channels (normalized
    per-slice), maps seg labels {0,1,2,4} -> {0,1,2}, and splits subjects
    80/20 (sorted order, deterministic)."""
    subjects = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    xs, ys = [], []
    for s in subjects:
        sdir = os.path.join(root, s)
        files = {f.lower(): os.path.join(sdir, f) for f in os.listdir(sdir)}

        def _mod(name):
            # exact modality suffix: "_t1" must not match "..._t1ce.nii.gz"
            for k, p in files.items():
                if k.endswith((f"{name}.nii", f"{name}.nii.gz")):
                    return _read_nifti(p)
            return None

        seg = _mod("_seg")
        mods = [m for m in (_mod("_t1ce"), _mod("_t1"), _mod("_t2"), _mod("_flair"))
                if m is not None][:3]
        if seg is None or not mods:
            continue
        while len(mods) < 3:
            mods.append(mods[-1])
        chans = []
        for m in mods:
            sl = _mid_slice_resized(m, size)
            denom = sl.max() - sl.min()
            chans.append((sl - sl.min()) / (denom if denom > 0 else 1.0))
        mask = _mid_slice_resized(seg, size).astype(np.int32)
        mask = np.where(mask >= 2, 2, mask)
        xs.append(np.stack(chans, axis=-1))
        ys.append(mask)
    if len(xs) < 2:
        return None
    x, y = np.stack(xs), np.stack(ys)
    cut = max(1, int(0.8 * len(x)))
    return x[:cut], y[:cut], x[cut:], y[cut:]


# -- edge-case backdoor example pools (ARDIS / Southwest) --------------------


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
