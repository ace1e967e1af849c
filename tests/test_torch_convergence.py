"""The synthetic convergence gates of ``tests/test_parity.py``
(``TestSyntheticConvergenceGates``) on the port: the same configuration
shapes and thresholds, run through ``init`` -> ``data.load`` ->
``models.hub.create`` -> ``FedMLRunner`` on the CPU.  The synthetic data is
the JAX package's bit for bit, so the thresholds carry over.

Here: mnist ``lr`` on the ``sp`` simulator and on the round simulator, 50
clients (10 a round), 20 rounds, batch 10, lr 0.03, ``test_acc`` >= 0.90.
The cifar ResNet-20 trajectory (> 0.15) and the shakespeare ``rnn`` shape
(> 0) run on the card in ``chip_smoke.py`` phase 21d, with these two again.
"""

import pytest
import torch

import fedml_tpu_torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gate_config(backend, *, dataset="mnist", model="lr", clients=(50, 10), rounds=20,
                batch=10, lr=0.03, train_size=2500, device="cpu", **train_extra):
    """``tests/test_parity.py``'s ``_cfg``, with the port's device knob."""
    return {
        "common_args": {"training_type": "simulation", "random_seed": 0,
                        "run_id": f"parity-{backend}-{dataset}-{model}"},
        "data_args": {"dataset": dataset, "data_cache_dir": "",
                      "partition_method": "hetero", "partition_alpha": 0.5,
                      "synthetic_train_size": train_size},
        "model_args": {"model": model},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": clients[0],
                       "client_num_per_round": clients[1], "comm_round": rounds,
                       "epochs": 1, "batch_size": batch, "client_optimizer": "sgd",
                       "learning_rate": lr, **train_extra},
        "validation_args": {"frequency_of_the_test": max(rounds // 2, 1)},
        "device_args": {"device_type": device},
        "comm_args": {"backend": backend},
    }


def run_gate(config):
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, classes)
    return fedml_tpu_torch.FedMLRunner(args, fedml_tpu_torch.device.get_device(args), dataset,
                                       model).run()


@pytest.mark.parametrize("backend", ["sp", "XLA"])
def test_mnist_lr_gate(backend):
    metrics = run_gate(gate_config(backend))
    assert metrics["test_acc"] >= 0.90, metrics
