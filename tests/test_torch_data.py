"""The port's arguments and data path against the JAX package's: the same
config gives the same attributes, and ``data.load`` gives bit-identical
arrays and partition maps (numpy on both sides, so exact equality)."""

import copy

import numpy as np
import pytest

import fedml_tpu
import fedml_tpu_torch

SLICE_CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "shakespeare", "partition_method": "hetero",
                  "partition_alpha": 0.5},
    "model_args": {"model": "transformer"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 100,
                   "client_num_per_round": 10, "comm_round": 3, "epochs": 1,
                   "batch_size": 32, "client_optimizer": "sgd", "learning_rate": 0.1},
    "validation_args": {"frequency_of_the_test": 1},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "XLA"},
}


def _both(config):
    return (fedml_tpu.Arguments.from_dict(copy.deepcopy(config)).validate(),
            fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)).validate())


def test_arguments_give_the_same_attributes():
    j, t = _both(SLICE_CONFIG)
    assert t.to_dict() == j.to_dict()


def test_validation_rejects_what_the_jax_package_rejects():
    bad = copy.deepcopy(SLICE_CONFIG)
    bad["train_args"]["client_num_per_round"] = 101
    for pkg in (fedml_tpu, fedml_tpu_torch):
        with pytest.raises(ValueError, match="client_num_per_round"):
            pkg.Arguments.from_dict(copy.deepcopy(bad)).validate()


@pytest.mark.parametrize("method", ["homo", "hetero"])
def test_shakespeare_arrays_and_partitions_are_bit_identical(method):
    config = copy.deepcopy(SLICE_CONFIG)
    config["data_args"].update(partition_method=method, synthetic_train_size=2000)
    config["train_args"]["client_num_in_total"] = 20
    j, t = _both(config)
    ds_j, classes_j = fedml_tpu.data.data_loader.load(j)
    ds_t, classes_t = fedml_tpu_torch.data.data_loader.load(t)
    assert classes_t == classes_j == 90
    assert ds_t[0] == ds_j[0] and ds_t[1] == ds_j[1] and ds_t[7] == ds_j[7]
    for split in (2, 3):  # global train / test (x, y)
        for a, b in zip(ds_t[split], ds_j[split]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ds_t[4] == ds_j[4]  # per-client sample counts
    for i in range(20):
        for local in (5, 6):  # per-client train / test shards
            for a, b in zip(ds_t[local][i], ds_j[local][i]):
                assert np.array_equal(a, b), (method, local, i)
    assert t.dataset_is_synthetic and j.dataset_is_synthetic


def test_unported_dataset_kind_raises():
    config = copy.deepcopy(SLICE_CONFIG)
    config["data_args"]["dataset"] = "cifar10"
    _, t = _both(config)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fedml_tpu_torch.data.data_loader.load(t)
