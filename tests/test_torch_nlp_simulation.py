"""The FedNLP task family end to end: ``init`` -> ``data.load`` ->
``models.hub.create`` -> ``FedMLRunner`` on the port against the JAX
package on the same configs, from the JAX init transplanted.

* ``sp`` FedAvg, 4 clients of 16 samples, 2 rounds, one full batch per
  epoch (where the engines' different shuffles cannot matter), SGD: global
  params after each round within 2e-5 for ``agnews`` / ``transformer_cls``,
  ``onto_tagging`` / ``transformer_tagger`` and ``stackoverflow_lr`` /
  ``lr`` (tag prediction: one-hot labels, BCE), and within 5e-5 for
  ``squad_span`` / ``transformer_span`` and ``synthetic_s2s`` /
  ``transformer_s2s`` (a 2-layer causal LM over L 24: the port's kernels as
  their plain versions); the eval dicts, which both round to 4 decimals,
  within 2e-4, with the same task extras (F1, exact match).
* FedProx and SCAFFOLD on ``synthetic_s2s``, one round each, within 5e-5.
  The JAX SCAFFOLD builds the classification trainer for every dataset,
  whose CE reads the -1 labels as the last token; the port's takes the
  dataset's trainer (ROADMAP.md C), so the JAX run here is given the
  seq2seq trainer.
* The round simulator's padded and packed rounds (``XLA``, one-device JAX
  mesh) on ``synthetic_s2s`` (token inputs kept integer under
  ``xla_data_dtype: bf16``) and ``stackoverflow_lr`` (class ids stored
  one-hot, the ``bce`` loss): global params after each of 2 rounds within
  5e-5.
"""

import copy

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import fedml_tpu
import fedml_tpu_torch
import test_torch_sp_simulator as _sp
import test_torch_sp_zoo as _zoo
from fedml_tpu.parallel.mesh import create_fl_mesh
from fedml_tpu.simulation.xla import fed_sim as jfed_sim
from fedml_tpu_torch.models import convert

CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "synthetic_s2s", "partition_method": "homo",
                  "synthetic_train_size": 64},
    "model_args": {"model": "transformer_s2s"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 4,
                   "client_num_per_round": 4, "comm_round": 2, "epochs": 1,
                   "batch_size": 16, "client_optimizer": "sgd", "learning_rate": 0.1},
    "validation_args": {"frequency_of_the_test": 1},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "sp"},
}
# (dataset, model, tolerance on the global params)
SP_RUNS = {
    "agnews": ("transformer_cls", 2e-5),
    "onto_tagging": ("transformer_tagger", 2e-5),
    "stackoverflow_lr": ("lr", 2e-5),
    "squad_span": ("transformer_span", 5e-5),
    "synthetic_s2s": ("transformer_s2s", 5e-5),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_singletons():
    yield
    _sp._reset_singletons()


def _config(dataset, model, **train):
    config = copy.deepcopy(CONFIG)
    config["data_args"]["dataset"] = dataset
    config["model_args"]["model"] = model
    config["train_args"].update(train)
    return config


# -- sp ------------------------------------------------------------------------------


@pytest.mark.parametrize("dataset", sorted(SP_RUNS))
def test_sp_fedavg_matches_jax(dataset):
    model, atol = SP_RUNS[dataset]
    config = _config(dataset, model)
    jlog, _, init, _ = _zoo.jax_run(config)
    _sp._reset_singletons()
    tlog, tapi = _zoo.port_run(config, init)
    assert tlog["trained"] == jlog["trained"] and len(tlog["states"]) == 2
    assert max(tapi.train_data_local_num_dict.values()) <= 16  # one full batch
    _sp._assert_states_close(tlog["states"], jlog["states"], atol, dataset)
    _sp._assert_evals_close(tlog["evals"], jlog["evals"])
    for got, want in zip(tlog["evals"], jlog["evals"]):
        assert sorted(got) == sorted(want)
        for key in set(want) - {"round", "test_acc", "test_loss"}:
            assert abs(got[key] - want[key]) <= 2e-4, (key, got, want)


@pytest.mark.parametrize("member", ["FedProx", "SCAFFOLD"])
def test_zoo_member_on_seq2seq_matches_jax(member):
    from fedml_tpu.ml.trainer.s2s_trainer import ModelTrainerS2S as JS2S
    from fedml_tpu.simulation.sp.scaffold import scaffold_api as jscaffold

    knobs = {"FedProx": {"federated_optimizer": "FedProx", "proximal_mu": 0.1},
             "SCAFFOLD": {"federated_optimizer": "SCAFFOLD", "epochs": 2}}[member]
    config = _config("synthetic_s2s", "transformer_s2s", comm_round=1, **knobs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jscaffold, "ModelTrainerCLS", JS2S)
        jlog, _, init, _ = _zoo.jax_run(config)
    _sp._reset_singletons()
    tlog, tapi = _zoo.port_run(config, init)
    assert type(tapi).__name__ == _zoo.CLASSES[member] and tapi.trainer.loss_kind == "s2s"
    assert tlog["trained"] == jlog["trained"]
    _sp._assert_states_close(tlog["states"], jlog["states"], 5e-5, member)
    _sp._assert_evals_close(tlog["evals"], jlog["evals"])


# -- the round simulator ------------------------------------------------------------


def _xla_runs(config):
    """The JAX XLASimulator on a one-device mesh and the port's, from the
    same init: (global params after each round, JAX then port; the port's
    simulator).  The JAX init is placed where the round puts its outputs
    (replicated on the mesh), so round 1 reuses round 0's compiled program
    instead of compiling it again for another input placement."""
    jargs = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(config)),
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
    repl = NamedSharding(jsim.mesh, PartitionSpec())
    jsim.variables = jax.device_put(jsim.variables, repl)
    jsim.server_state = jax.device_put(jsim.server_state, repl)
    jstates, tstates = [], []
    round_fn = jsim._round_fn

    def recorded_round(*a):
        out = round_fn(*a)
        jstates.append(convert.state_from_flax(jax.tree_util.tree_map(np.asarray, out[0])))
        return out

    jsim._round_fn = recorded_round

    targs = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)),
                                 should_init_logs=False)
    device = fedml_tpu_torch.device.get_device(targs)
    tdataset, tclasses = fedml_tpu_torch.data.load(targs)
    tmodel = fedml_tpu_torch.models.hub.create(targs, tclasses)
    tsim = fedml_tpu_torch.FedMLRunner(targs, device, tdataset, tmodel).runner.sim
    tsim.variables = convert.variables_from_flax(
        jax.tree_util.tree_map(np.asarray, jsim.variables), tmodel, device)
    name = "_run_packed_round" if tsim.packed else "_run_round"
    run = getattr(tsim, name)

    def recorded(*a):
        out = run(*a)
        tstates.append({k: v.numpy().copy() for k, v in tsim.variables.items()})
        return out

    setattr(tsim, name, recorded)
    jsim.train()
    tsim.train()
    return jstates, tstates, tsim


@pytest.mark.parametrize("pack", [False, True], ids=["padded", "packed"])
@pytest.mark.parametrize("dataset", ["synthetic_s2s", "stackoverflow_lr"])
def test_xla_round_matches_jax(dataset, pack):
    model = SP_RUNS[dataset][0]
    # the padded round takes one full batch a client (its shuffles are the
    # engines' own); the packed round's are numpy's on both sides
    config = _config(dataset, model, xla_pack=pack, batch_size=8 if pack else 16,
                     xla_data_dtype="bf16" if dataset == "synthetic_s2s" else "auto")
    config["comm_args"]["backend"] = "XLA"
    config["validation_args"]["frequency_of_the_test"] = 0
    jstates, tstates, tsim = _xla_runs(config)
    assert tsim.packed == pack and len(tstates) == len(jstates) == 2
    if dataset == "synthetic_s2s":
        assert tsim.loss_kind == "s2s" and not torch.is_floating_point(tsim.x_all)
    else:
        assert tsim.loss_kind == "bce" and tsim.y_all.dtype is torch.float32
        assert tsim.y_all.shape == (64, 500) and bool((tsim.y_all.sum(1) == 1).all())
    _sp._assert_states_close(tstates, jstates, 5e-5, f"{dataset} pack={pack}")
