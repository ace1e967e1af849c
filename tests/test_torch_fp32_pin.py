"""The scoped fp32 pin (``device.fp32_matmul``): inside it cuBLAS's and
cuDNN's TF32 flags are off, and on the way out both come back to the values
it found, whatever they were, also when the block raises.  The simulators'
``train`` run inside it, so a run keeps its fp32 products and leaves the
process's flags as it found them (on the card: ``cuda``-marked, skipped
without one).  Torch only: the card tests run with ``--noconftest``.
"""

import copy

import pytest
import torch

import fedml_tpu_torch
from fedml_tpu_torch.device import fp32_matmul

STARTS = [(True, True), (False, True), (True, False), (False, False)]
CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "mnist", "partition_method": "hetero", "partition_alpha": 0.5,
                  "synthetic_train_size": 400},
    "model_args": {"model": "lr"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 8,
                   "client_num_per_round": 4, "comm_round": 1, "epochs": 1,
                   "batch_size": 64, "client_optimizer": "sgd", "learning_rate": 0.05},
    "validation_args": {"frequency_of_the_test": 1},
    "device_args": {"device_type": "gpu"},
}


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def _set(flags):
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.fixture(autouse=True)
def _saved_flags():
    saved = _flags()
    yield
    _set(saved)


@pytest.mark.parametrize("start", STARTS)
def test_fp32_matmul_restores_both_flags(start):
    _set(start)
    with fp32_matmul():
        assert _flags() == (False, False)
        with fp32_matmul():  # nested: the inner one restores the outer's
            assert _flags() == (False, False)
        assert _flags() == (False, False)
    assert _flags() == start
    with pytest.raises(RuntimeError, match="inside"):
        with fp32_matmul():
            raise RuntimeError("inside")
    assert _flags() == start


@pytest.mark.cuda
@pytest.mark.parametrize("backend,inner", [("XLA", "sim"), ("sp", "fl_trainer")])
def test_train_on_the_card_leaves_the_tf32_flags_as_it_found_them(backend, inner):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config = copy.deepcopy(CONFIG)
    config["comm_args"] = {"backend": backend}
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    runner = fedml_tpu_torch.FedMLRunner(args, fedml_tpu_torch.device.get_device(args),
                                         dataset, fedml_tpu_torch.models.hub.create(args, classes))
    sim = getattr(runner.runner, inner)
    seen = []
    train = sim._train

    def inside():
        seen.append(_flags())
        return train()

    sim._train = inside
    for start in ((True, True), (False, True)):
        _set(start)
        runner.run()
        assert seen[-1] == (False, False)
        assert _flags() == start
