"""The FedGraphNN family end to end: ``init`` -> ``data.load`` ->
``models.hub.create`` -> ``FedMLRunner`` on the port against the JAX
package on the same configs, from the JAX init transplanted.

* ``sp`` FedAvg, one full batch per epoch (where the engines' different
  shuffles cannot matter), SGD, 2 rounds: global params after each round
  within 2e-5 for ``ego_linkpred`` / ``gcn_linkpred``, ``moleculenet_mtl`` /
  ``gcn_mtl``, ``ego_nodeclf`` / ``gcn_nodeclf`` and ``freesolv`` /
  ``gcn_reg`` (4 clients of 16 graphs), and for
  ``app/fedgraphnn/fedml_config.yaml`` (``sider`` / ``gcn``, hetero over 8
  clients, 4 a round) with SGD and a batch that holds a client; the eval
  dicts within 2e-4 (both round to 4 decimals).
* SpreadGNN on ``sp`` (``examples/simulation/sp_spreadgnn_moleculenet_gcn``
  with SGD and one full batch) against the JAX ``SpreadGNNAPI``: every model
  set for eval (the consensus, then each node's with its own head) within
  2e-5; its gossip keeps the heads node-local and mixes the encoder.
* The port's in-mesh ``DecentralizedInMeshAPI`` (``lr`` / ``mnist``) and
  ``SpreadGNNInMeshAPI`` (``moleculenet_mtl``) under ``backend: XLA``
  against the port's ``sp`` twins, two steps an epoch: every node's model
  (and the consensus) bit for bit, the padded shapes agreeing; and against
  the JAX in-mesh twins (one-device mesh), one full batch: within 2e-5.
  The in-mesh round refuses a model attack and local DP, which its JAX twin
  skips silently.
* The round simulator's padded and packed rounds on ``ego_linkpred`` (float
  -1/0/1 labels [B, N, N]) and ``freesolv`` (targets [B, 1]): the labels
  reach the loss as fp32, and global params after each of 2 rounds within
  5e-5 of JAX.
* The example configs as they stand (adam) run on the port, on ``sp`` and
  on ``XLA``.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
import yaml

import fedml_tpu
import fedml_tpu_torch
import test_torch_nlp_simulation as _nlp
import test_torch_sp_simulator as _sp
import test_torch_sp_zoo as _zoo
from fedml_tpu.parallel.mesh import create_fl_mesh
from fedml_tpu_torch.models import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "ego_linkpred", "partition_method": "homo",
                  "synthetic_train_size": 64},
    "model_args": {"model": "gcn_linkpred"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 4,
                   "client_num_per_round": 4, "comm_round": 2, "epochs": 1,
                   "batch_size": 16, "client_optimizer": "sgd", "learning_rate": 0.1},
    "validation_args": {"frequency_of_the_test": 1},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "sp"},
}
SP_RUNS = {"ego_linkpred": "gcn_linkpred", "moleculenet_mtl": "gcn_mtl",
           "ego_nodeclf": "gcn_nodeclf", "freesolv": "gcn_reg"}
EXAMPLES = {
    "examples/simulation/sp_fedavg_linkpred_gcn/fedml_config.yaml": "FedAvgAPI",
    "examples/simulation/sp_spreadgnn_moleculenet_gcn/fedml_config.yaml": "SpreadGNNAPI",
    "examples/simulation/xla_spreadgnn_moleculenet_gcn/fedml_config.yaml": "SpreadGNNAPI",
    "examples/simulation/xla_decentralized_mnist_lr/fedml_config.yaml": "DecentralizedInMeshAPI",
    "app/fedgraphnn/fedml_config.yaml": "FedAvgAPI",
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


def _yaml(path):
    with open(os.path.join(REPO, path)) as f:
        return yaml.safe_load(f)


def _sp_parity(config, atol):
    jlog, _, init, japi = _zoo.jax_run(config)
    _sp._reset_singletons()
    tlog, tapi = _zoo.port_run(config, init)
    assert tlog["trained"] == jlog["trained"]
    _sp._assert_states_close(tlog["states"], jlog["states"], atol, config["data_args"]["dataset"])
    _sp._assert_evals_close(tlog["evals"], jlog["evals"])
    for got, want in zip(tlog["evals"], jlog["evals"]):
        assert sorted(got) == sorted(want)
        for key in set(want) - {"round", "test_acc", "test_loss"}:
            assert abs(got[key] - want[key]) <= 2e-4, (key, got, want)
    return tlog, tapi


# -- sp ------------------------------------------------------------------------------


@pytest.mark.parametrize("dataset", sorted(SP_RUNS))
def test_sp_fedavg_matches_jax(dataset):
    tlog, tapi = _sp_parity(_config(dataset, SP_RUNS[dataset]), 2e-5)
    assert len(tlog["states"]) == 2
    assert max(tapi.train_data_local_num_dict.values()) <= 16  # one full batch


def test_app_fedgraphnn_config_matches_jax():
    config = _yaml("app/fedgraphnn/fedml_config.yaml")
    config["device_args"] = {"device_type": "cpu"}
    config["data_args"].update(synthetic_train_size=160, data_cache_dir="")
    config["train_args"].update(client_optimizer="sgd", learning_rate=0.1, batch_size=128,
                                comm_round=2)
    config["validation_args"]["frequency_of_the_test"] = 1
    config.pop("tracking_args", None)
    tlog, tapi = _sp_parity(config, 2e-5)
    assert len(tlog["trained"]) == 8 and len(set(tapi.train_data_local_num_dict.values())) > 1
    assert max(tapi.train_data_local_num_dict.values()) <= 128  # one batch an epoch


def _spreadgnn_config(**train):
    config = _yaml("examples/simulation/sp_spreadgnn_moleculenet_gcn/fedml_config.yaml")
    config["device_args"] = {"device_type": "cpu"}
    config["data_args"].update(synthetic_train_size=64, data_cache_dir="")
    config["train_args"].update(client_optimizer="sgd", learning_rate=0.1, **train)
    config.pop("tracking_args", None)
    return config


def test_sp_spreadgnn_matches_jax():
    tlog, tapi = _sp_parity(_spreadgnn_config(), 2e-5)
    assert type(tapi).__name__ == "SpreadGNNAPI"
    # each round: the consensus, then the 4 nodes' models for the eval
    assert len(tlog["states"]) == 2 * (1 + 4)
    heads = [k for k in tapi.w_global if k.startswith("readout.")]
    assert heads and any(not torch.equal(tapi.node_models[0][k], tapi.node_models[1][k])
                         for k in heads)


def test_spreadgnn_gossip_keeps_the_heads_local():
    from fedml_tpu_torch.simulation.sp.spreadgnn.spreadgnn_api import SpreadGNNAPI

    _, tapi = _zoo.port_run(_spreadgnn_config(comm_round=0))
    assert isinstance(tapi, SpreadGNNAPI)
    stacked = {k: torch.stack([torch.full_like(v, float(i)) for i in range(4)])
               for k, v in tapi.w_global.items()}
    mixed = tapi._gossip(stacked)
    seen = set()
    for k, x in mixed.items():
        own = [float(x[i].flatten()[0]) for i in range(4)]
        if k.startswith("readout."):
            seen.add("head")
            assert own == [0.0, 1.0, 2.0, 3.0], k  # untouched
        else:
            seen.add("encoder")
            assert own != [0.0, 1.0, 2.0, 3.0], k  # the neighbours' average
            want = tapi.mix @ torch.arange(4, dtype=torch.float32)
            assert torch.allclose(torch.tensor(own), want), k
    assert seen == {"head", "encoder"}


# -- the in-mesh decentralized round --------------------------------------------------


def _inmesh_configs(member, one_batch):
    """(config, the number of nodes) of the in-mesh parity runs: ``lr`` on
    ``mnist`` for decentralized FL, ``gcn_mtl`` for SpreadGNN; two steps an
    epoch unless ``one_batch``."""
    per_node = 16 if one_batch else 32
    if member == "decentralized_fl":
        config = _config("mnist", "lr", federated_optimizer="decentralized_fl",
                         client_num_in_total=4, client_num_per_round=4,
                         topology_neighbor_num=2)
    else:
        config = _spreadgnn_config()
    config["data_args"].update(synthetic_train_size=4 * per_node, partition_method="homo")
    return config


def _port_api(config, backend):
    config = copy.deepcopy(config)
    config["comm_args"] = {"backend": backend}
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    device = fedml_tpu_torch.device.get_device(args)
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, classes)
    runner = fedml_tpu_torch.FedMLRunner(args, device, dataset, model)
    return runner, (runner.runner.sim if backend == "XLA" else runner.runner.fl_trainer)


@pytest.mark.parametrize("member", ["decentralized_fl", "SpreadGNN"])
def test_inmesh_twin_equals_the_sp_twin_bit_for_bit(member):
    config = _inmesh_configs(member, one_batch=False)
    sp_runner, sp_api = _port_api(config, "sp")
    sp_final = sp_runner.run()
    _sp._reset_singletons()
    runner, api = _port_api(config, "XLA")
    want_cls = "DecentralizedInMeshAPI" if member == "decentralized_fl" else "SpreadGNNInMeshAPI"
    assert type(api).__name__ == want_cls
    assert api.padded_n == sp_api.trainer.padded_size(32, 16) == 32  # two steps an epoch
    final = runner.run()
    assert len(api.round_times) == 2
    for nid in range(4):
        got, want = api.node_params(nid), sp_api.node_models[nid]
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (member, nid, k)
    if member == "decentralized_fl":
        for k, v in sp_api.w_global.items():
            assert torch.equal(api.consensus[k], v), k
    assert final == sp_final


@pytest.mark.parametrize("hook", ["model attack", "local DP"])
def test_inmesh_round_refuses_the_trust_hooks(hook):
    """The JAX in-mesh round runs no trust hook (its engine has no
    after-hook, its round no server hook) and skips them silently; the
    port's refuses each when it is on.  Its sp twin runs local DP."""
    from test_torch_sp_zoo_hooks import HOOK_KNOBS

    config = _inmesh_configs("decentralized_fl", one_batch=True)
    config["train_args"].update(HOOK_KNOBS[hook])
    with pytest.raises(NotImplementedError, match=f"runs no trust hook \\({hook} requested"):
        _port_api(config, "XLA")


def _transplant(api, jinit, model):
    """The port's in-mesh table from the JAX init, every node the same."""
    init = convert.variables_from_flax(jinit, model, torch.device("cpu"))
    api.table = {k: v.unsqueeze(0).repeat((api.n_nodes,) + (1,) * v.dim()) for k, v in init.items()}
    api.consensus = init


@pytest.mark.parametrize("member", ["decentralized_fl", "SpreadGNN"])
def test_inmesh_twin_matches_jax(member):
    from fedml_tpu.simulation.xla.decentralized import (DecentralizedInMeshAPI,
                                                        SpreadGNNInMeshAPI)

    config = _inmesh_configs(member, one_batch=True)
    config["comm_args"] = {"backend": "XLA"}
    jargs = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(config)),
                           should_init_logs=False)
    jdataset, classes = fedml_tpu.data.data_loader.load(jargs)
    jmodel = fedml_tpu.models.hub.create(jargs, classes)
    jcls = DecentralizedInMeshAPI if member == "decentralized_fl" else SpreadGNNInMeshAPI
    japi = jcls(jargs, None, jdataset, jmodel, mesh=create_fl_mesh(devices=jax.devices()[:1]))
    jinit = jax.tree_util.tree_map(np.asarray, japi.consensus)
    jfinal = japi.train()
    _sp._reset_singletons()
    runner, api = _port_api(config, "XLA")
    _transplant(api, jinit, api.module)
    final = runner.run()
    for nid in range(4):
        want = convert.state_from_flax(jax.tree_util.tree_map(np.asarray, japi.node_params(nid)))
        got = api.node_params(nid)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=2e-5,
                                       err_msg=f"{member} node {nid} {k}")
    assert final["round"] == jfinal["round"] == 1
    for key in ("test_acc", "test_loss"):
        assert abs(final[key] - jfinal[key]) <= 2e-4, (key, final, jfinal)


# -- the round simulator ------------------------------------------------------------


@pytest.mark.parametrize("pack", [False, True], ids=["padded", "packed"])
@pytest.mark.parametrize("dataset", ["ego_linkpred", "freesolv"])
def test_xla_round_matches_jax(dataset, pack):
    # the padded round takes one full batch a client (its shuffles are the
    # engines' own); the packed round's are numpy's on both sides
    config = _config(dataset, SP_RUNS[dataset], xla_pack=pack, batch_size=8 if pack else 16)
    config["comm_args"]["backend"] = "XLA"
    config["validation_args"]["frequency_of_the_test"] = 0
    jstates, tstates, tsim = _nlp._xla_runs(config)
    assert tsim.packed == pack and len(tstates) == len(jstates) == 2
    assert tsim.y_all.dtype is torch.float32  # the labels keep their dtype
    if dataset == "ego_linkpred":
        assert tsim.loss_kind == "linkpred" and tsim.y_all.shape == (64, 16, 16)
        assert set(torch.unique(tsim.y_all).tolist()) == {-1.0, 0.0, 1.0}
    else:
        assert tsim.loss_kind == "mse" and tsim.y_all.shape == (64, 1)
    _sp._assert_states_close(tstates, jstates, 5e-5, f"{dataset} pack={pack}")


# -- the example configs as they stand --------------------------------------------------


@pytest.mark.parametrize("path", sorted(EXAMPLES))
def test_example_config_runs_on_the_port(path, tmp_path):
    config = _yaml(path)
    config["device_args"] = {"device_type": "cpu"}
    config.setdefault("tracking_args", {})["log_file_dir"] = str(tmp_path)
    config["data_args"]["data_cache_dir"] = str(tmp_path / "fedml_data")  # absent: synthetic
    backend = config["comm_args"]["backend"]
    runner, api = _port_api(config, backend)
    final = runner.run()
    assert type(api).__name__ == EXAMPLES[path]
    assert 0.0 <= final["test_acc"] <= 1.0 and np.isfinite(final["test_loss"])
    assert final["round"] == int(config["train_args"]["comm_round"]) - 1
