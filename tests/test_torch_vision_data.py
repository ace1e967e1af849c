"""The vision tasks' data on the port against the JAX package.

* ``make_segmentation`` and ``make_detection``: bit for bit (numpy on both
  sides), over seeds, sizes and ``proto_seed``.
* ``data.load``'s ``segmentation`` (``synthetic_seg``, ``pascal_voc``,
  ``fets2021`` with no files) and ``detection`` (``synthetic_det``,
  ``coco_det``) splits with their hetero partitions (the dominant foreground
  class of a mask, the class column of a box label) and the homo one: every
  array and the partition bit for bit.
* The FeTS 2021 NIfTI parser on ``tests/fixtures/golden/fets2021``: the
  port's ``_read_nifti``, ``_mid_slice_resized`` and ``load_fets_nifti``
  against the JAX package's, bit for bit, and against the oracle of
  ``tests/test_loaders_golden.py::TestFetsNifti`` (the volumes it wrote,
  redrawn from its seed); ``try_load_real``'s dispatch and ``data.load``
  with the fixture as the cache directory.
"""

import copy
import os

import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden")
CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "synthetic_seg", "partition_method": "hetero",
                  "partition_alpha": 0.5, "synthetic_train_size": 120},
    "model_args": {"model": "unet"},
    "train_args": {"federated_optimizer": "FedSeg", "client_num_in_total": 4,
                   "client_num_per_round": 2, "comm_round": 1, "epochs": 1,
                   "batch_size": 16, "client_optimizer": "sgd", "learning_rate": 0.05},
    "validation_args": {"frequency_of_the_test": 1},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "sp"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(config):
    return (fedml_tpu.Arguments.from_dict(copy.deepcopy(config)).validate(),
            fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)).validate())


def _config(dataset, **data):
    config = copy.deepcopy(CONFIG)
    config["data_args"].update(dataset=dataset, **data)
    return config


def _assert_same(got, want, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert np.array_equal(got, want), what


# -- generators ------------------------------------------------------------------------


@pytest.mark.parametrize("name,args,kw", [
    ("make_segmentation", (12,), {}),
    ("make_segmentation", (12, (32, 32)), {"proto_seed": 3}),
    ("make_segmentation", (9, (24, 16)), {}),
    ("make_detection", (12, (32, 32), 6), {}),
    ("make_detection", (9, (24, 40), 3), {}),
])
def test_generator_is_bit_identical(name, args, kw):
    from fedml_tpu.data import synthetic as jsynthetic
    from fedml_tpu_torch.data import synthetic

    for seed in (0, 7):
        got = getattr(synthetic, name)(*args, seed=seed, **kw)
        want = getattr(jsynthetic, name)(*args, seed=seed, **kw)
        for a, b in zip(got, want):
            _assert_same(a, b, name)
    if name == "make_segmentation":
        x, masks = got
        assert set(np.unique(masks)) <= {0, 1, 2} and x.shape == masks.shape + (3,)
    else:
        x, y = got
        assert y.dtype == np.float32 and y.shape == (args[0], 5)
        assert ((y[:, 1:] > 0) & (y[:, 1:] <= 1)).all()  # normalised boxes


# -- loader kinds ------------------------------------------------------------------------


@pytest.mark.parametrize("dataset,method", [
    ("synthetic_seg", "hetero"), ("pascal_voc", "homo"), ("fets2021", "hetero"),
    ("synthetic_det", "hetero"), ("coco_det", "homo"),
])
def test_load_is_bit_identical(dataset, method):
    j, t = _both(_config(dataset, partition_method=method))
    ds_j, classes_j = fedml_tpu.data.data_loader.load(j)
    ds_t, classes_t = fedml_tpu_torch.data.data_loader.load(t)
    assert classes_t == classes_j and t.dataset_is_synthetic
    assert ds_t[0] == ds_j[0] and ds_t[1] == ds_j[1] and ds_t[7] == ds_j[7]
    for split in (2, 3):  # global train / test (x, y)
        for a, b in zip(ds_t[split], ds_j[split]):
            _assert_same(a, b, split)
    assert ds_t[4] == ds_j[4]  # per-client sample counts: the partition
    for i in range(4):
        for local in (5, 6):  # per-client train / test shards
            for a, b in zip(ds_t[local][i], ds_j[local][i]):
                _assert_same(a, b, (local, i))
    kind = fedml_tpu_torch.data.data_loader.DATASET_SPECS[dataset]["kind"]
    y = ds_t[2][1]
    if kind == "segmentation":
        assert y.dtype == np.int32 and y.shape[1:] == (32, 32)
    else:
        assert y.dtype == np.float32 and y.shape[1:] == (5,)
    if method == "hetero":
        assert len(set(ds_t[4].values())) > 1  # the buckets skew the split


# -- the FeTS 2021 parser ------------------------------------------------------------------


def _fets_volumes():
    """The fixture's volumes, redrawn as TestFetsNifti draws them."""
    r = np.random.RandomState(17)
    vols = {}
    for s in ("FeTS21_001", "FeTS21_002"):
        for mod, dt in (("_t1", np.int16), ("_t1ce", np.int16), ("_t2", np.int16),
                        ("_flair", np.int16), ("_seg", np.uint8)):
            shape = (8, 8, 4)
            if mod == "_seg":
                vols[(s, mod)] = r.choice([0, 1, 2, 4], size=shape).astype(dt)
            else:
                vols[(s, mod)] = r.randint(0, 1000, shape).astype(dt)
    return vols


def test_nifti_reader_and_slice_match_jax():
    from fedml_tpu.data import loaders as jloaders
    from fedml_tpu_torch.data import loaders

    vols = _fets_volumes()
    root = os.path.join(GOLDEN, "fets2021")
    for subject in sorted(os.listdir(root)):
        for fn in sorted(os.listdir(os.path.join(root, subject))):
            path = os.path.join(root, subject, fn)
            got, want = loaders._read_nifti(path), jloaders._read_nifti(path)
            _assert_same(got, want, fn)
            mod = fn[len(subject):].split(".")[0]
            _assert_same(got, vols[(subject, mod)], fn)  # the volume written
            for size in (32, 5):
                _assert_same(loaders._mid_slice_resized(got, size),
                             jloaders._mid_slice_resized(want, size), (fn, size))


def test_fets_parser_matches_jax_and_its_oracle():
    from fedml_tpu.data import loaders as jloaders
    from fedml_tpu_torch.data import loaders

    root = os.path.join(GOLDEN, "fets2021")
    got, want = loaders.load_fets_nifti(root), jloaders.load_fets_nifti(root)
    for a, b in zip(got, want):
        _assert_same(a, b)
    xt, yt, xe, ye = got
    assert xt.shape == (1, 32, 32, 3) and xe.shape == (1, 32, 32, 3)
    vols = _fets_volumes()

    def expect_slice(vol, size=32):
        sl = vol[:, :, vol.shape[2] // 2].astype(np.float32)
        iy = np.linspace(0, sl.shape[0] - 1, size).astype(int)
        ix = np.linspace(0, sl.shape[1] - 1, size).astype(int)
        return sl[np.ix_(iy, ix)]

    for ci, mod in enumerate(("_t1ce", "_t1", "_t2")):  # flair dropped as the 4th
        sl = expect_slice(vols[("FeTS21_001", mod)])
        denom = sl.max() - sl.min()
        np.testing.assert_allclose(xt[0, :, :, ci], (sl - sl.min()) / (denom if denom > 0 else 1.0),
                                   atol=1e-6)
    exp_mask = expect_slice(vols[("FeTS21_001", "_seg")]).astype(np.int32)
    np.testing.assert_array_equal(yt[0], np.where(exp_mask >= 2, 2, exp_mask))
    # the dispatch: fets2021 under the cache directory parses, as in JAX
    for cache in (GOLDEN, root):
        for a, b in zip(loaders.try_load_real("fets2021", cache),
                        jloaders.try_load_real("fets2021", cache)):
            _assert_same(a, b, cache)


def test_load_reads_the_cached_fets_volumes():
    config = _config("fets2021", data_cache_dir=GOLDEN, partition_method="homo")
    config["train_args"].update(client_num_in_total=1, client_num_per_round=1)
    j, t = _both(config)
    got = fedml_tpu_torch.data.data_loader.load_centralized(t)
    want = fedml_tpu.data.data_loader.load_centralized(j)
    assert t.dataset_is_synthetic is False and j.dataset_is_synthetic is False
    for key in ("x_train", "y_train", "x_test", "y_test"):
        _assert_same(got[key], want[key], key)
    assert got["x_train"].shape == (1, 32, 32, 3) and got["class_num"] == 3
