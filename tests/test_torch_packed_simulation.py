"""The packed round through the simulator: 3 rounds of FedAvg of a ResNet-20
(fp32) on cifar10 (synthetic, 8 Dirichlet clients, 4 a round, batch 16),
the port through ``init`` -> ``data.load`` -> ``models.hub.create`` ->
``FedMLRunner`` with ``xla_pack``, against the JAX package's
``XLASimulator`` on a one-device mesh, the port's layout.

Both start from the JAX init, transplanted.  Each round they must pick the
same cohort, lay it out in the same order, and stream the same batches: the
packed schedule's arrays are equal bit for bit (host numpy on both sides).
The global parameters after each round agree within atol 5e-5 (fp32, sums
taken in other orders; they read 2.9e-6, 5.6e-6 and 1.0e-5 after rounds 0-2).
The learning rate, 0.005, is near bench.py's 0.001.  At 0.05 this model's
loss rises round over round, and the two drift apart as roundoff grows
(3.1e-5, 1.4e-4, 2.2e-4), while a single gradient of the two agrees to
4e-6 in norm on every leaf.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.parallel.mesh import create_fl_mesh
from fedml_tpu.simulation.xla import fed_sim as jfed_sim
from fedml_tpu_torch.models import convert


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "cifar10", "partition_method": "hetero", "partition_alpha": 0.5,
                  "synthetic_train_size": 200},
    "model_args": {"model": "resnet20"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 8,
                   "client_num_per_round": 4, "comm_round": 3, "epochs": 1, "batch_size": 16,
                   "client_optimizer": "sgd", "learning_rate": 0.005, "xla_pack": True},
    "validation_args": {"frequency_of_the_test": 0},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "XLA"},
}


def _record(sim, log):
    """Record each round's cohort, its layout and its packed stream."""
    sample, schedule, packed = sim._client_sampling, sim._schedule, sim._packed_inputs

    def sampling(round_idx):
        ids = sample(round_idx)
        log["cohorts"].append([int(c) for c in ids])
        return ids

    def scheduled(sampled):
        ids, real = schedule(sampled)
        log["orders"].append([int(c) for c, r in zip(ids, real) if r])
        return ids, real

    def packed_inputs(*a):
        sched = packed(*a)
        log["streams"].append([np.asarray(x).reshape(-1) for x in sched[:4]])
        return sched

    sim._client_sampling, sim._schedule, sim._packed_inputs = sampling, scheduled, packed_inputs


@pytest.fixture(scope="module")
def runs():
    jlog = {"cohorts": [], "orders": [], "streams": [], "variables": []}
    tlog = copy.deepcopy(jlog)

    jargs = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(CONFIG)),
                           should_init_logs=False)
    jdataset, classes = fedml_tpu.data.data_loader.load(jargs)
    jmodel = fedml_tpu.models.hub.create(jargs, classes)
    with pytest.MonkeyPatch.context() as mp:
        # the same init, jitted: flax's op-by-op init costs seconds a layer
        mp.setattr(jfed_sim, "init_variables", lambda module, sample, seed=0: dict(
            jax.jit(lambda k, s: module.init(k, s, train=False))(
                jax.random.PRNGKey(seed), sample)))
        jsim = jfed_sim.XLASimulator(jargs, jdataset, jmodel,
                                     mesh=create_fl_mesh(devices=jax.devices()[:1]))
    round_fn = jsim._round_fn

    def recorded_round(*a):
        out = round_fn(*a)
        jlog["variables"].append(convert.params_state_from_flax(
            jax.tree_util.tree_map(np.asarray, out[0])))
        return out

    jsim._round_fn = recorded_round
    _record(jsim, jlog)

    targs = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(CONFIG)),
                                 should_init_logs=False)
    device = fedml_tpu_torch.device.get_device(targs)
    tdataset, tclasses = fedml_tpu_torch.data.load(targs)
    tmodel = fedml_tpu_torch.models.hub.create(targs, tclasses)
    trun = fedml_tpu_torch.FedMLRunner(targs, device, tdataset, tmodel)
    tsim = trun.runner.sim
    tsim.variables = convert.variables_from_flax(
        jax.tree_util.tree_map(np.asarray, jsim.variables), tmodel, device)
    run_round = tsim._run_packed_round

    def recorded_packed_round(*a):
        out = run_round(*a)
        tlog["variables"].append({k: v.numpy().copy() for k, v in tsim.variables.items()})
        return out

    tsim._run_packed_round = recorded_packed_round
    _record(tsim, tlog)
    jsim.train()
    trun.run()
    return jlog, tlog, jsim, tsim


def test_same_cohorts_in_the_same_stream_order(runs):
    jlog, tlog, jsim, tsim = runs
    assert tsim.packed and jsim.packed and jsim.n_dev == 1
    assert len(tlog["cohorts"]) == 3
    assert tlog["cohorts"] == jlog["cohorts"]
    assert tlog["orders"] == jlog["orders"]
    for r, (ts, js) in enumerate(zip(tlog["streams"], jlog["streams"])):
        for name, a, b in zip(("idx", "mask", "boundary", "weight"), ts, js):
            assert np.array_equal(a, b), (r, name)


def test_global_params_agree_after_each_round(runs):
    jlog, tlog, *_ = runs
    assert len(tlog["variables"]) == len(jlog["variables"]) == 3
    for r, (tv, jv) in enumerate(zip(tlog["variables"], jlog["variables"])):
        assert sorted(tv) == sorted(jv)
        for name in tv:
            np.testing.assert_allclose(tv[name], jv[name], atol=5e-5,
                                       err_msg=f"round {r} {name}")


def test_losses_and_throughput(runs):
    *_, jsim, tsim = runs
    assert len(tsim.round_losses) == 3 and all(np.isfinite(tsim.round_losses))
    assert tsim.samples_per_round == jsim.samples_per_round
    assert tsim.throughput()["samples_per_sec"] > 0
