"""The port's arguments and data path against the JAX package's: the same
config gives the same attributes, and ``data.load`` gives bit-identical
arrays and partition maps (numpy on both sides, so exact equality), for the
next-word-prediction data and the NHWC ``cifar10`` images.  The simulator's
bf16 storage of float data gives the same bits as the fp32 rows cast to
bf16, as the JAX package's storage does."""

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


def _assert_loads_identical(ds_t, ds_j, n_clients):
    assert ds_t[0] == ds_j[0] and ds_t[1] == ds_j[1] and ds_t[7] == ds_j[7]
    for split in (2, 3):  # global train / test (x, y)
        for a, b in zip(ds_t[split], ds_j[split]):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert ds_t[4] == ds_j[4]  # per-client sample counts
    for i in range(n_clients):
        for local in (5, 6):  # per-client train / test shards
            for a, b in zip(ds_t[local][i], ds_j[local][i]):
                assert np.array_equal(a, b), (local, i)


CIFAR_CONFIG = copy.deepcopy(SLICE_CONFIG)
CIFAR_CONFIG["data_args"].update(dataset="cifar10", synthetic_train_size=2000)
CIFAR_CONFIG["model_args"].update(model="resnet20", compute_dtype="bf16")


def test_cifar10_arrays_and_hetero_partition_are_bit_identical():
    """bench.py's data: cifar10 (synthetic fallback, NHWC), Dirichlet 0.5
    over 100 clients, at a reduced synthetic size."""
    j, t = _both(CIFAR_CONFIG)
    ds_j, classes_j = fedml_tpu.data.data_loader.load(j)
    ds_t, classes_t = fedml_tpu_torch.data.data_loader.load(t)
    assert classes_t == classes_j == 10
    assert ds_t[2][0].shape == (2000, 32, 32, 3) and ds_t[2][0].dtype == np.float32
    _assert_loads_identical(ds_t, ds_j, 100)
    assert t.dataset_is_synthetic and j.dataset_is_synthetic


def test_bf16_storage_gathers_the_fp32_rows_cast_to_bf16():
    """A ResNet computing in bf16 stores the float data in bf16: a gathered
    batch equals the fp32 batch cast to bf16 bit for bit, and the bits are
    the JAX package's bf16 storage's."""
    import jax.numpy as jnp
    import torch

    config = copy.deepcopy(CIFAR_CONFIG)
    config["data_args"]["synthetic_train_size"] = 400
    config["train_args"].update(client_num_in_total=8, client_num_per_round=4,
                                xla_pack=True)
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, classes)
    sim = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model).runner.sim
    x_fp32 = np.concatenate([dataset[5][i][0] for i in range(8)])
    assert sim.x_all.dtype is torch.bfloat16 and sim.y_all.dtype is torch.int32
    rows = np.random.RandomState(0).choice(len(x_fp32), 64)
    got = sim.x_all.index_select(0, torch.from_numpy(rows))
    want = torch.from_numpy(x_fp32[rows]).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    jax_bits = np.asarray(jnp.asarray(x_fp32[rows], jnp.bfloat16)).view(np.int16)
    assert np.array_equal(got.view(torch.int16).numpy(), jax_bits)
    # fp32 compute keeps fp32 storage
    config["model_args"]["compute_dtype"] = "fp32"
    args = fedml_tpu_torch.Arguments.from_dict(config)
    sim = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset,
                                      fedml_tpu_torch.models.hub.create(args, 10)).runner.sim
    assert sim.x_all.dtype is torch.float32


def test_unported_dataset_kind_raises():
    # every kind of the table is ported now, the IoT reconstruction kind
    # last (tests/test_torch_iot.py): iot_anomaly loads with JAX's shapes
    # and types, its train targets the inputs and its test labels the flags
    config = copy.deepcopy(SLICE_CONFIG)
    config["data_args"]["dataset"] = "iot_anomaly"
    j, t = _both(config)
    want, _ = fedml_tpu.data.data_loader.load(j)
    got, classes = fedml_tpu_torch.data.data_loader.load(t)
    assert classes == 2 and got[0] == want[0] and got[1] == want[1]
    for (gx, gy), (wx, wy) in ((got[2], want[2]), (got[3], want[3])):
        assert gx.shape == wx.shape and gx.dtype == wx.dtype == np.float32
        assert gy.shape == wy.shape and gy.dtype == wy.dtype
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    assert got[2][1].shape == got[2][0].shape and got[3][1].dtype == np.int32
