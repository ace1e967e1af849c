"""The slice as a whole: FedAvg of a TransformerLM on shakespeare through
``init`` -> ``data.load`` -> ``FedMLRunner``, the port against the JAX
package's XLASimulator.

Both start from the same global model (the JAX init, transplanted), train 2
rounds of 4 of 8 clients for 2 epochs with one full batch per epoch (so the
engines' different shuffles cannot matter), and must pick identical cohorts
each round, laid out in the same order: the JAX round lays its cohort out
through the LPT scheduler (heaviest first) and the port's padded round
trains the clients in that order.  On the CPU the JAX simulator attends through
``reference_attention``, the Pallas kernels' own oracle; the port through its
kernels' plain versions.  Tolerances: global parameters after each round
atol 5e-5 (fp32, two epochs of SGD at lr 0.1 with sums in other orders);
eval loss and accuracy, which both packages round to 4 decimals, 2e-4.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.models.transformer import TransformerConfig as JCfg, TransformerLM as JLM
from fedml_tpu_torch.models import convert
from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM


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
    "data_args": {"dataset": "shakespeare", "partition_method": "homo",
                  "synthetic_train_size": 320},
    "model_args": {"model": "transformer"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 8,
                   "client_num_per_round": 4, "comm_round": 2, "epochs": 2,
                   "batch_size": 64, "client_optimizer": "sgd", "learning_rate": 0.1},
    "validation_args": {"frequency_of_the_test": 1},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "XLA"},
}
CFG = dict(vocab_size=96, d_model=32, n_heads=2, n_layers=1, d_ff=64)


def _record(sim, variables_of):
    """Wrap the simulator's cohort draw, its layout and per-round eval to
    record the cohort, the clients in layout order, the global variables
    after the round, and the eval dict."""
    log = {"cohorts": [], "orders": [], "trained": [], "variables": [], "evals": []}
    sample, schedule, test = sim._client_sampling, sim._schedule, sim._test_global

    def scheduled(sampled):
        ids, real = schedule(sampled)
        log["orders"].append([int(c) for c, r in zip(ids, real) if r])
        return ids, real

    def sampling(round_idx):
        ids = sample(round_idx)
        log["cohorts"].append([int(c) for c in ids])
        return ids

    def test_global(round_idx):
        log["variables"].append(variables_of(sim))
        out = test(round_idx)
        log["evals"].append(out)
        return out

    sim._client_sampling, sim._schedule, sim._test_global = sampling, scheduled, test_global
    return log


@pytest.fixture(scope="module")
def runs():
    jargs = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(CONFIG)),
                           should_init_logs=False)
    jdataset, _ = fedml_tpu.data.data_loader.load(jargs)
    jrun = fedml_tpu.FedMLRunner(jargs, fedml_tpu.device.get_device(jargs), jdataset,
                                 JLM(JCfg(**CFG)))
    jsim = jrun.runner.sim

    targs = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(CONFIG)),
                                 should_init_logs=False)
    device = fedml_tpu_torch.device.get_device(targs)
    tdataset, _ = fedml_tpu_torch.data.load(targs)
    tmodel = TransformerLM(TransformerConfig(**CFG), device="meta")
    trun = fedml_tpu_torch.FedMLRunner(targs, device, tdataset, tmodel)
    tsim = trun.runner.sim
    # one start: the JAX init, carried across
    tsim.variables = convert.variables_from_flax(
        jax.tree_util.tree_map(np.asarray, jsim.variables), tmodel, device)

    jlog = _record(jsim, lambda s: convert.transformer_state_from_flax(
        jax.tree_util.tree_map(np.asarray, s.variables)))
    tlog = _record(tsim, lambda s: {k: v.numpy().copy() for k, v in s.variables.items()})
    local_train = tsim._local_train

    def trained(variables, x, y, n_valid, seed, extra=None):
        tlog["trained"].append(int(seed[2]))  # seed = (run seed, round, client)
        return local_train(variables, x, y, n_valid, seed=seed, extra=extra)

    tsim._local_train = trained
    jfinal, tfinal = jrun.run(), trun.run()
    return jlog, tlog, jfinal, tfinal, tsim


def test_cohorts_are_identical(runs):
    jlog, tlog, *_ = runs
    assert len(tlog["cohorts"]) == 2
    assert tlog["cohorts"] == jlog["cohorts"]


def test_padded_round_trains_in_the_reference_layout_order(runs):
    """The JAX layout on its 8-device mesh puts the k-th heaviest client on
    device k, so its real slots read heaviest first, as the port's one slot."""
    jlog, tlog, *_, tsim = runs
    assert len(tlog["orders"]) == 2 and tlog["orders"] == jlog["orders"]
    assert tlog["trained"] == [c for order in tlog["orders"] for c in order]
    for cohort, order in zip(tlog["cohorts"], tlog["orders"]):
        sizes = [tsim.local_num_dict[c] for c in order]
        assert sorted(order) == sorted(cohort) and sizes == sorted(sizes, reverse=True)


def test_global_params_agree_after_each_round(runs):
    jlog, tlog, *_ = runs
    assert len(tlog["variables"]) == len(jlog["variables"]) == 2
    for r, (tv, jv) in enumerate(zip(tlog["variables"], jlog["variables"])):
        assert sorted(tv) == sorted(jv)
        for name in tv:
            np.testing.assert_allclose(tv[name], jv[name], atol=5e-5,
                                       err_msg=f"round {r} {name}")


def test_eval_dicts_agree(runs):
    jlog, tlog, jfinal, tfinal, _ = runs
    for te, je in zip(tlog["evals"], jlog["evals"]):
        assert te["round"] == je["round"]
        for key in ("test_acc", "test_loss"):
            assert abs(te[key] - je[key]) <= 2e-4, (key, te, je)
    assert tfinal == tlog["evals"][-1]


def test_throughput_reports_tokens(runs):
    *_, tsim = runs
    tp = tsim.throughput()
    assert tp["samples_per_sec"] > 0 and tp["tokens_per_sec"] == tp["samples_per_sec"] * 80
    assert tsim.samples_trained == 2 * 2 * 4 * 40


def test_unported_knobs_raise():
    for knob, value in (("xla_client_chunk", 4), ("population_stacked", True),
                        ("dp_plane", "compiled"), ("agg_plane", "compiled"),
                        ("server_state", "sharded"),
                        ("checkpoint_dir", "ckpt"), ("obs_trace", True)):
        config = copy.deepcopy(CONFIG)
        config["train_args"][knob] = value
        args = fedml_tpu_torch.Arguments.from_dict(config)
        from fedml_tpu_torch.simulation.xla.fed_sim import refuse_unported_knobs

        with pytest.raises(NotImplementedError, match=knob):
            refuse_unported_knobs(args)
    config = copy.deepcopy(CONFIG)
    config["train_args"]["federated_optimizer"] = "FedGKT"
    with pytest.raises(NotImplementedError, match="fedgkt"):
        from fedml_tpu_torch.simulation.xla.algorithms import create_inmesh_algorithm

        create_inmesh_algorithm(fedml_tpu_torch.Arguments.from_dict(config))
