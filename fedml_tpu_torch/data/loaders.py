"""Parsers for locally cached real dataset files (no downloads): a copy of
``fedml_tpu/data/loaders.py``, numpy only.

Every format the JAX package parses: the MNIST idx-ubyte files (plain or
gzipped), the LEAF json layout (femnist, the next-word-prediction datasets,
stackoverflow_lr), the CIFAR python pickles, the ImageFolder layout (CINIC-10
and the ImageNet family), tabular CSVs (UCI, lending_club), the Google
Landmarks mapping CSVs with their images, the NUS-WIDE multi-label
features, the FeTS 2021 NIfTI volumes (read without nibabel: the middle
axial slice of each subject, resized) and the edge-case example pools of the
edge-case backdoor.  ``try_load_real`` dispatches as the JAX package's does,
its fallbacks included (mnist: the idx files, then LEAF json; cinic10: the
image folder, then the CIFAR pickles); a dataset with no parser, or whose
files are not there, gives None and the caller generates synthetic data.

One divergence, kept on purpose: the image-folder and landmarks parsers
need Pillow.  Where the JAX package returns None without it, and so trains
on synthetic data silently, the port raises an ``ImportError`` naming
Pillow when the cache holds image files.
"""

from __future__ import annotations

import gzip
import json
import os
import pickle
import struct
from typing import Optional, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _pillow(where: str):
    """PIL's ``Image``, or an ``ImportError`` naming Pillow and the image
    files at ``where`` that need it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{where} holds image files, and reading them needs Pillow, which is not "
            "installed (the JAX package trains on synthetic data here instead)") from e
    return Image


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(root: str, *names: str) -> Optional[str]:
    for dirpath, _, files in os.walk(root):
        for n in names:
            if n in files:
                return os.path.join(dirpath, n)
            for f in files:
                if f == n + ".gz":
                    return os.path.join(dirpath, f)
    return None


def load_mnist_idx(root: str) -> Optional[Arrays]:
    """The MNIST idx-ubyte release (plain or ``.gz``): NHWC float32 in [0, 1]
    (28x28x1), int32 labels; None unless all four files are there."""
    paths = [
        _find(root, "train-images-idx3-ubyte"),
        _find(root, "train-labels-idx1-ubyte"),
        _find(root, "t10k-images-idx3-ubyte"),
        _find(root, "t10k-labels-idx1-ubyte"),
    ]
    if any(p is None for p in paths):  # partial cache -> synthetic fallback
        return None
    xt = _read_idx(paths[0]).astype(np.float32) / 255.0
    yt = _read_idx(paths[1]).astype(np.int32)
    xe = _read_idx(paths[2]).astype(np.float32) / 255.0
    ye = _read_idx(paths[3]).astype(np.int32)
    return xt[..., None], yt, xe[..., None], ye


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


def load_image_folder(root: str, size: int = 32) -> Optional[Arrays]:
    """ImageFolder layout (CINIC-10 release format): ``{train,test}/<class>/
    *.png`` (test may be ``valid`` or ``val``); class = sorted subdirectory
    index; RGB resized to ``size`` x ``size``, float32 in [0, 1].  Needs
    Pillow once an image file is found."""

    def _split(split_dir):
        if not os.path.isdir(split_dir):
            return None
        classes = sorted(
            d for d in os.listdir(split_dir)
            if os.path.isdir(os.path.join(split_dir, d))
        )
        if not classes:
            return None
        xs, ys = [], []
        for ci, cname in enumerate(classes):
            cdir = os.path.join(split_dir, cname)
            for f in sorted(os.listdir(cdir)):
                if not f.lower().endswith((".png", ".jpg", ".jpeg")):
                    continue
                img = _pillow(cdir).open(os.path.join(cdir, f)).convert("RGB")
                if img.size != (size, size):
                    img = img.resize((size, size))
                xs.append(np.asarray(img, np.float32) / 255.0)
                ys.append(ci)
        if not xs:
            return None
        return np.stack(xs), np.asarray(ys, np.int32)

    train = _split(os.path.join(root, "train"))
    test = (_split(os.path.join(root, "test")) or _split(os.path.join(root, "valid"))
            or _split(os.path.join(root, "val")))
    if train is None or test is None:
        return None
    return train[0], train[1], test[0], test[1]


def load_csv_labeled(root: str) -> Optional[Arrays]:
    """Tabular CSV parser (UCI / lending_club-style files): ``train.csv``
    (+ optional ``test.csv``, else a seeded shuffle and an 80/20 split).  The
    label column is the one named 'label'/'target'/'y' in the header, else
    the LAST column; features must be numeric."""
    train_path = _find(root, "train.csv")
    if train_path is None:
        return None

    def _parse(path):
        with open(path) as f:
            header = f.readline().strip().split(",")
        names = [h.strip().lower() for h in header]
        has_header = not all(_is_float(h) for h in names)
        data = np.genfromtxt(path, delimiter=",", skip_header=1 if has_header else 0,
                             dtype=np.float64)
        if data.ndim == 1:
            data = data[None, :]
        label_col = len(names) - 1
        if has_header:
            for cand in ("label", "target", "y"):
                if cand in names:
                    label_col = names.index(cand)
                    break
        y = data[:, label_col].astype(np.int32)
        x = np.delete(data, label_col, axis=1).astype(np.float32)
        return x, y

    xt, yt = _parse(train_path)
    test_path = _find(root, "test.csv")
    if test_path is not None:
        xe, ye = _parse(test_path)
    else:
        # seeded shuffle before the 80/20 split: exported CSVs are often
        # label-sorted, and an unshuffled tail would be single-class
        perm = np.random.RandomState(0).permutation(len(yt))
        xt, yt = xt[perm], yt[perm]
        cut = max(int(len(yt) * 0.8), 1)
        xe, ye = xt[cut:], yt[cut:]
        xt, yt = xt[:cut], yt[:cut]
        if len(ye) == 0:
            xe, ye = xt, yt  # degenerate tiny file: eval on train
    return xt, yt, xe, ye


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def try_load_real(name: str, cache_dir: str) -> Optional[Arrays]:
    """Real files for ``name`` under ``cache_dir``'s ``name`` subdirectory,
    else under ``cache_dir`` itself, by the JAX package's dispatch; None
    (synthetic data) when neither holds them."""
    if not cache_dir or not os.path.isdir(cache_dir):
        return None
    for root in (os.path.join(cache_dir, name), cache_dir):
        if not os.path.isdir(root):
            continue
        if name in ("mnist", "fashionmnist"):
            out = load_mnist_idx(root) or load_leaf_json(root)
        elif name == "femnist":
            out = load_leaf_json(root)
        elif name == "cinic10":
            out = load_image_folder(root) or load_cifar_pickle(root)
        elif name.startswith("cifar") or name == "fed_cifar100":
            out = load_cifar_pickle(root)
        elif name in ("shakespeare", "fed_shakespeare", "stackoverflow_nwp", "stackoverflow_lr"):
            out = load_leaf_json(root)
        elif name in ("uci", "lending_club"):
            out = load_csv_labeled(root)
        elif name in ("imagenet", "ilsvrc2012", "tiny_imagenet"):
            out = load_imagenet_folder(root)
        elif name in ("gld23k", "gld160k", "landmarks"):
            out = load_landmarks_csv(root)
        elif name in ("nuswide", "nus_wide"):
            out = load_nuswide(root)
        elif name == "fets2021":
            out = load_fets_nifti(root)
        else:
            out = None
        if out is not None:
            return out
    return None


def load_imagenet_folder(root: str, size: int = 32) -> Optional[Arrays]:
    """ImageNet/ILSVRC2012 directory layout: ``train/<wnid>/*.JPEG`` +
    ``val/<wnid>/*.JPEG``, the ImageFolder traversal of CINIC-10 (class
    index = sorted wnid order), resized to ``size`` (downsampled-ImageNet
    style)."""
    return load_image_folder(root, size=size)


def load_landmarks_csv(root: str, size: int = 32) -> Optional[Arrays]:
    """Google Landmarks federated split: mapping CSVs with ``user_id,
    image_id,class`` columns and an image directory.  Train CSV is the first
    of ``*train*.csv`` / ``data_user.csv``; test is ``*test*.csv``; images are
    searched as ``<image_id>.jpg`` under ``images/``, ``train/``, or the root.
    Needs Pillow once an image file is found."""
    import csv as _csv
    import glob as _glob

    def _find_csv(*pats):
        for p in pats:
            hits = sorted(_glob.glob(os.path.join(root, p)))
            if hits:
                return hits[0]
        return None

    train_csv = _find_csv("*train*.csv", "data_user.csv")
    test_csv = _find_csv("*test*.csv")
    if train_csv is None or test_csv is None:
        return None
    img_dirs = [os.path.join(root, d) for d in ("images", "train", "")]

    def _load_split(path):
        xs, ys = [], []
        with open(path, newline="") as f:
            rows = list(_csv.DictReader(f))
        if not rows or not {"image_id", "class"} <= set(rows[0]):
            return None
        for row in rows:
            fname = row["image_id"] + ".jpg"
            for d in img_dirs:
                p = os.path.join(d, fname)
                if os.path.isfile(p):
                    img = _pillow(d).open(p).convert("RGB")
                    if img.size != (size, size):
                        img = img.resize((size, size))
                    xs.append(np.asarray(img, np.float32) / 255.0)
                    ys.append(int(row["class"]))
                    break
        if not xs:
            return None
        return np.stack(xs), np.asarray(ys, np.int32)

    train, test = _load_split(train_csv), _load_split(test_csv)
    if train is None or test is None:
        return None
    return train[0], train[1], test[0], test[1]


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
