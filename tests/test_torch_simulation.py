"""The slice as a whole: FedAvg of a TransformerLM on shakespeare through
``init`` -> ``data.load`` -> ``FedMLRunner``, the port against the JAX
package's XLASimulator.

Both start from the same global model (the JAX init, transplanted), train 2
rounds of 4 of 8 clients for 2 epochs with one full batch per epoch (so the
engines' different shuffles cannot matter), and must pick identical cohorts
each round.  On the CPU the JAX simulator attends through
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
    """Wrap the simulator's cohort draw and per-round eval to record the
    cohort, the global variables after the round, and the eval dict."""
    log = {"cohorts": [], "variables": [], "evals": []}
    sample, test = sim._client_sampling, sim._test_global

    def sampling(round_idx):
        ids = sample(round_idx)
        log["cohorts"].append([int(c) for c in ids])
        return ids

    def test_global(round_idx):
        log["variables"].append(variables_of(sim))
        out = test(round_idx)
        log["evals"].append(out)
        return out

    sim._client_sampling, sim._test_global = sampling, test_global
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
    jfinal, tfinal = jrun.run(), trun.run()
    return jlog, tlog, jfinal, tfinal, tsim


def test_cohorts_are_identical(runs):
    jlog, tlog, *_ = runs
    assert len(tlog["cohorts"]) == 2
    assert tlog["cohorts"] == jlog["cohorts"]


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
    for knob, value in (("xla_pack", True), ("fl_mode", "async"), ("server_state", "sharded"),
                        ("checkpoint_dir", "ckpt"), ("obs_trace", True)):
        config = copy.deepcopy(CONFIG)
        config["train_args"][knob] = value
        args = fedml_tpu_torch.Arguments.from_dict(config)
        from fedml_tpu_torch.simulation.xla.fed_sim import refuse_unported_knobs

        with pytest.raises(NotImplementedError, match=knob):
            refuse_unported_knobs(args)
    config = copy.deepcopy(CONFIG)
    config["train_args"]["federated_optimizer"] = "FedOpt"
    with pytest.raises(NotImplementedError, match="FedOpt"):
        from fedml_tpu_torch.simulation.xla.algorithms import create_inmesh_algorithm

        create_inmesh_algorithm(fedml_tpu_torch.Arguments.from_dict(config))
