"""The last data parsers of the port against the JAX package's
(``fedml_tpu/data/loaders.py``), on the committed byte fixtures under
``tests/fixtures/golden/`` (nothing is downloaded).

* Each parser (``load_mnist_idx`` on the plain train and gzipped test files,
  ``load_image_folder`` and ``load_imagenet_folder`` on the CINIC-10 PNGs,
  ``load_csv_labeled`` with and without ``test.csv``, ``load_landmarks_csv``
  on the JPEGs) gives JAX's arrays bit for bit: equal dtypes, equal values,
  no tolerance.  The image parsers yield their ``DATASET_SPECS`` sample
  shape (mnist 28x28x1; cinic10, imagenet and gld23k 32x32x3); a CSV's is
  its file's width, which ``data.load`` hands the hub.
* ``try_load_real`` dispatches as JAX's does, bit for bit, for every family
  of ``tests/test_loaders_golden.py::test_dispatch_finds_each_family``, for
  the other names of those families (fashionmnist, imagenet, ilsvrc2012,
  tiny_imagenet, lending_club, gld160k, landmarks) and for the two
  fallbacks (mnist's LEAF json, cinic10's CIFAR pickles); an unknown name and
  an empty cache give None on both sides.
* Without Pillow the image parsers raise an ``ImportError`` naming Pillow
  when the cache holds images (the JAX twin falls back to synthetic data),
  and give None, as JAX does, where there is no image to read.
* ``split_data_for_dist_trainers`` equals JAX's.
* The mnist idx and uci CSV fixtures through ``data.load`` give JAX's
  partitions bit for bit and train the hub's ``lr`` (784 and 3 inputs) for a
  round on the CPU.
"""

import builtins
import copy
import os
import shutil

import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.data import data_loader_cross_silo as jcross_silo, loaders as jloaders
from fedml_tpu_torch.data import data_loader_cross_silo, loaders

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_same(got, want, what):
    assert got is not None and want is not None and len(got) == len(want) == 4, what
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), what


def _mount(tmp_path, name, fixture):
    """``cache_dir/<name>/...`` holding the fixture, as a user mounts it."""
    shutil.copytree(os.path.join(GOLD, fixture), tmp_path / name)
    return str(tmp_path)


@pytest.mark.parametrize("parser,fixture,shape", [
    ("load_mnist_idx", "mnist", (28, 28, 1)),
    ("load_image_folder", "cinic10", (32, 32, 3)),
    ("load_imagenet_folder", "cinic10", (32, 32, 3)),
    ("load_csv_labeled", "uci", (3,)),
    ("load_landmarks_csv", "gld23k", (32, 32, 3)),
])
def test_parser_matches_jax(parser, fixture, shape):
    root = os.path.join(GOLD, fixture)
    got, want = getattr(loaders, parser)(root), getattr(jloaders, parser)(root)
    _assert_same(got, want, parser)
    assert got[0].shape[1:] == got[2].shape[1:] == shape


def test_csv_without_a_test_file_splits_as_jax(tmp_path):
    shutil.copy(os.path.join(GOLD, "uci", "train.csv"), tmp_path / "train.csv")
    _assert_same(loaders.load_csv_labeled(str(tmp_path)),
                 jloaders.load_csv_labeled(str(tmp_path)), "80/20")
    for mod in (loaders, jloaders):  # a partial mnist cache: None
        shutil.copy(os.path.join(GOLD, "mnist", "train-images-idx3-ubyte"),
                    tmp_path / "train-images-idx3-ubyte")
        assert mod.load_mnist_idx(str(tmp_path)) is None


@pytest.mark.parametrize("name,fixture", [
    ("mnist", "mnist"), ("fashionmnist", "mnist"), ("mnist", "femnist"),
    ("cifar10", "cifar10"), ("femnist", "femnist"), ("cinic10", "cinic10"),
    ("cinic10", "cifar10"), ("uci", "uci"), ("lending_club", "uci"),
    ("imagenet", "cinic10"), ("ilsvrc2012", "cinic10"), ("tiny_imagenet", "cinic10"),
    ("gld23k", "gld23k"), ("gld160k", "gld23k"), ("landmarks", "gld23k"),
    ("nuswide", "nuswide"), ("fets2021", "fets2021"),
])
def test_dispatch_matches_jax(name, fixture, tmp_path):
    cache = _mount(tmp_path, name, fixture)
    _assert_same(loaders.try_load_real(name, cache), jloaders.try_load_real(name, cache),
                 (name, fixture))


def test_no_files_give_none_as_in_jax(tmp_path):
    for name in ("mnist", "cinic10", "uci", "gld23k", "synthetic"):
        assert loaders.try_load_real(name, str(tmp_path)) is None
        assert jloaders.try_load_real(name, str(tmp_path)) is None
    cache = _mount(tmp_path, "synthetic", "mnist")  # no parser for the name
    assert loaders.try_load_real("synthetic", cache) is None
    assert jloaders.try_load_real("synthetic", cache) is None


@pytest.fixture
def no_pillow(monkeypatch):
    real_import = builtins.__import__

    def guarded(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", guarded)


def test_images_without_pillow_raise_naming_it(no_pillow, tmp_path):
    for name, fixture in (("cinic10", "cinic10"), ("imagenet", "cinic10"),
                          ("gld23k", "gld23k")):
        with pytest.raises(ImportError, match="Pillow"):
            loaders.try_load_real(name, _mount(tmp_path / name, name, fixture))
    # no image file to read: None, as the JAX twin gives, without Pillow
    empty = tmp_path / "empty"
    (empty / "train" / "airplane").mkdir(parents=True)
    (empty / "test" / "airplane").mkdir(parents=True)
    assert loaders.load_image_folder(str(empty)) is None
    # the parsers that need no Pillow still read their files
    _assert_same(loaders.try_load_real("cinic10", _mount(tmp_path / "c", "cinic10", "cifar10")),
                 jloaders.load_cifar_pickle(os.path.join(GOLD, "cifar10")), "cifar fallback")


@pytest.mark.parametrize("n", [0, 1, 3, 4])
def test_split_data_for_dist_trainers_matches_jax(n):
    rs = np.random.RandomState(n)
    data = (rs.randn(10, 3).astype(np.float32), rs.randint(0, 5, 10).astype(np.int32))
    got = data_loader_cross_silo.split_data_for_dist_trainers(data, n)
    want = jcross_silo.split_data_for_dist_trainers(data, n)
    assert len(got) == len(want) == max(n, 1)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


@pytest.mark.parametrize("dataset,width", [("mnist", 784), ("uci", 3)])
def test_real_files_through_data_load_train_lr(dataset, width):
    config = {
        "common_args": {"training_type": "simulation", "random_seed": 0},
        "data_args": {"dataset": dataset, "data_cache_dir": GOLD, "partition_method": "homo"},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 2,
                       "client_num_per_round": 2, "comm_round": 1, "epochs": 1,
                       "batch_size": 4, "client_optimizer": "sgd", "learning_rate": 0.1},
        "validation_args": {"frequency_of_the_test": 1},
        "device_args": {"device_type": "cpu"},
        "comm_args": {"backend": "XLA"},
    }
    jargs = fedml_tpu.Arguments.from_dict(copy.deepcopy(config)).validate()
    want, _ = fedml_tpu.data.data_loader.load(jargs)
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)),
                                should_init_logs=False)
    dataset_t, classes = fedml_tpu_torch.data.load(args)
    assert args.dataset_is_synthetic is False and jargs.dataset_is_synthetic is False
    for split in (2, 3):
        for a, b in zip(dataset_t[split], want[split]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for i in range(2):
        assert np.array_equal(dataset_t[5][i][1], want[5][i][1])
    model = fedml_tpu_torch.models.hub.create(args, classes)
    assert model.linear.in_features == width
    runner = fedml_tpu_torch.FedMLRunner(args, fedml_tpu_torch.device.get_device(args),
                                         dataset_t, model)
    result = runner.run()
    sim = runner.runner.sim
    assert len(sim.round_losses) == 1 and np.isfinite(sim.round_losses[0])
    assert 0.0 <= result["test_acc"] <= 1.0
