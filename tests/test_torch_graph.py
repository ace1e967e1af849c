"""The FedGraphNN family's modules on the port against their JAX twins.

* The five graph generators (graph classification, link prediction with its
  ``bipartite`` and ``holdout`` variants, multi-task graphs, node
  classification, graph regression) and ``data.load``'s ``graph``,
  ``linkpred``, ``mtl_graph``, ``nodeclf`` and ``graphreg`` splits with
  their hetero partitions (graph regression's quartile bins, link
  prediction's halved and multi-task's raw positive counts): bit for bit
  (numpy on both sides).
* The five GCN heads of the hub (``gcn``, ``gcn_linkpred``, ``gcn_nodeclf``,
  ``gcn_reg``, ``gcn_mtl``) at the hub's width (hidden 64, 2 layers, 16
  nodes, 8 features) from the flax init transplanted: outputs within 1e-5
  on padded graphs, and ``FlatLayout``'s row order equal to
  ``ravel_pytree``'s.
* The three losses (``linkpred``, ``mtl_bce``: the masked-sentinel BCE;
  ``mse``) on random logits with -1 labels, all -1 rows and all-padding
  masks: mean, total and count within 1e-6.
* The evals of ``ModelTrainerLinkPred``, ``ModelTrainerMTL`` and
  ``ModelTrainerReg`` (and the server aggregator that evaluates through
  them), and node classification's, which rides ``ModelTrainerNWP`` with
  [B, N] node labels: every metric within 1e-5.
* SpreadGNN's head rule: an exact match of one segment of the dotted name.
"""

import copy

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu_torch.ml.engine.train import init_variables, load_variables
from fedml_tpu_torch.models import convert

CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "ego_linkpred", "partition_method": "hetero",
                  "partition_alpha": 0.5, "synthetic_train_size": 96},
    "model_args": {"model": "gcn_linkpred"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 4,
                   "client_num_per_round": 4, "comm_round": 1, "epochs": 1,
                   "batch_size": 16, "client_optimizer": "sgd", "learning_rate": 0.1},
    "validation_args": {"frequency_of_the_test": 1},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "sp"},
}
# hub key -> (dataset, the port's class)
HEADS = {
    "gcn": ("sider", "GCN"),
    "gcn_linkpred": ("ego_linkpred", "GCNLinkPred"),
    "gcn_nodeclf": ("ego_nodeclf", "GCNNodeClassifier"),
    "gcn_reg": ("freesolv", "GCNRegressor"),
    "gcn_mtl": ("moleculenet_mtl", "GCN"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(dataset, model="gcn_linkpred", **data):
    config = copy.deepcopy(CONFIG)
    config["data_args"].update(dataset=dataset, **data)
    config["model_args"]["model"] = model
    return config


def _both(config):
    return (fedml_tpu.Arguments.from_dict(copy.deepcopy(config)).validate(),
            fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)).validate())


# -- data ------------------------------------------------------------------------


@pytest.mark.parametrize("name,args,kw", [
    ("make_graph_classification", (24, 16, 8, 4), {}),
    ("make_graph_classification", (24, 12, 5, 3), {"proto_seed": 3}),
    ("make_link_prediction", (24, 16, 8), {}),
    ("make_link_prediction", (24, 16, 8), {"bipartite": True}),
    ("make_link_prediction", (24, 10, 4), {"holdout": 0.6, "proto_seed": 2}),
    ("make_multitask_graphs", (24, 16, 8, 8), {}),
    ("make_multitask_graphs", (24, 12, 6, 5), {"label_frac": 0.4}),
    ("make_node_classification", (24, 16, 8, 3), {}),
    ("make_graph_regression", (24, 16, 8), {}),
])
def test_generator_is_bit_identical(name, args, kw):
    from fedml_tpu.data import synthetic as jsynthetic
    from fedml_tpu_torch.data import synthetic

    for seed in (0, 7):
        got = getattr(synthetic, name)(*args, seed=seed, **kw)
        want = getattr(jsynthetic, name)(*args, seed=seed, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name


@pytest.mark.parametrize("dataset,method", [
    ("sider", "hetero"), ("ego_linkpred", "hetero"), ("recsys_linkpred", "hetero"),
    ("moleculenet_mtl", "hetero"), ("ego_nodeclf", "hetero"), ("freesolv", "hetero"),
    ("freesolv", "homo"),
])
def test_load_is_bit_identical(dataset, method):
    j, t = _both(_config(dataset, partition_method=method))
    ds_j, classes_j = fedml_tpu.data.data_loader.load(j)
    ds_t, classes_t = fedml_tpu_torch.data.data_loader.load(t)
    assert classes_t == classes_j
    assert ds_t[0] == ds_j[0] and ds_t[1] == ds_j[1] and ds_t[7] == ds_j[7]
    for split in (2, 3):  # global train / test (x, y)
        for a, b in zip(ds_t[split], ds_j[split]):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert ds_t[4] == ds_j[4]  # per-client sample counts: the partition
    for i in range(4):
        for local in (5, 6):  # per-client train / test shards
            for a, b in zip(ds_t[local][i], ds_j[local][i]):
                assert np.array_equal(a, b), (local, i)
    if method == "hetero":
        assert len(set(ds_t[4].values())) > 1  # the buckets skew the split


# -- models ------------------------------------------------------------------------


_MODELS = {}


def _models(model):
    """(JAX module, flax variables, port module on the CPU with them loaded,
    its variables), built once a module."""
    if model not in _MODELS:
        dataset = HEADS[model][0]
        j, t = _both(_config(dataset, model))
        classes = fedml_tpu_torch.data.data_loader.DATASET_SPECS[dataset]["classes"]
        jmodel = fedml_tpu.models.hub.create(j, classes)
        tmodel = fedml_tpu_torch.models.hub.create(t, classes)
        sample = np.zeros((1, 16, 24), np.float32)
        jvars = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k, s: jmodel.init(k, s, train=False))(jax.random.PRNGKey(0), sample))
        if "score_bias" in jvars["params"]:  # a nonzero bias, so its leaf is checked
            jvars["params"]["score_bias"] = np.asarray(0.25, np.float32)
        cpu = torch.device("cpu")
        init_variables(tmodel, cpu)
        tvars = convert.variables_from_flax(jvars, tmodel, cpu)
        load_variables(tmodel, tvars)
        _MODELS[model] = (jmodel, jvars, tmodel, tvars)
    return _MODELS[model]


def _graphs(n=6, seed=1):
    """Graphs with padding nodes (all-zero feature rows and adjacency)."""
    from fedml_tpu_torch.data.synthetic import make_graph_classification

    x, _ = make_graph_classification(n, 16, 8, 4, seed=seed)
    return x


@pytest.mark.parametrize("model", sorted(HEADS))
def test_forward_matches_jax(model):
    jmodel, jvars, tmodel, tvars = _models(model)
    assert type(tmodel).__name__ == HEADS[model][1]
    x = _graphs()
    assert (np.abs(x[..., :8]).sum(-1) == 0).any()  # some nodes are padding
    want = np.asarray(jax.jit(lambda v, s: jmodel.apply(v, s, train=False))(jvars, x))
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if model == "gcn_mtl":
        assert got.shape[-1] == 8  # one logit a task
    # the round's client rows: the ravel_pytree order, column for column
    flat = convert.FlatLayout.of(tvars).ravel(tvars).numpy()
    assert np.array_equal(flat, np.asarray(ravel_pytree(jvars["params"])[0]))
    layout = convert.FlatLayout.of(tvars)
    back = layout.unravel(torch.from_numpy(flat), tvars)
    assert all(torch.equal(back[k], tvars[k]) for k in tvars)


# -- losses ------------------------------------------------------------------------


def _loss_inputs(kind, rng):
    B = 6
    if kind == "mse":
        return rng.randn(B, 1) * 3, rng.randn(B, 1).astype(np.float32)
    shape = (B, 5, 5) if kind == "linkpred" else (B, 8)
    labels = rng.randint(-1, 2, shape).astype(np.float32)
    labels[2] = -1  # a row with no label
    return rng.randn(*shape) * 3, labels


@pytest.mark.parametrize("mask", ["mixed", "all_padding"])
@pytest.mark.parametrize("kind", ["linkpred", "mtl_bce", "mse"])
def test_loss_matches_jax(kind, mask):
    from fedml_tpu.ml.engine import train as jtrain
    from fedml_tpu_torch.ml.engine import train

    logits, labels = _loss_inputs(kind, np.random.RandomState(3))
    logits = logits.astype(np.float32)
    m = (np.array([1, 1, 0, 1, 0, 1], np.float32) if mask == "mixed"
         else np.zeros(6, np.float32))
    got_mean, (got_total, got_count) = train.LOSS_FNS[kind](
        torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(m))
    want_mean, (want_total, want_count) = jtrain.LOSS_FNS[kind](logits, labels, m)
    for got, want in ((got_mean, want_mean), (got_total, want_total),
                      (got_count, want_count)):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    if mask == "all_padding":
        assert got_count.item() == 1.0 and got_total.item() == 0.0


# -- the task evals ------------------------------------------------------------------


@pytest.mark.parametrize("model,trainer", [
    ("gcn_linkpred", "ModelTrainerLinkPred"),
    ("gcn_mtl", "ModelTrainerMTL"),
    ("gcn_reg", "ModelTrainerReg"),
    ("gcn_nodeclf", "ModelTrainerNWP"),
])
def test_task_eval_matches_jax(model, trainer):
    from fedml_tpu.ml.aggregator.aggregator_creator import (
        create_server_aggregator as jcreate_aggregator)
    from fedml_tpu.ml.trainer.trainer_creator import create_model_trainer as jcreate
    from fedml_tpu_torch.ml.aggregator.aggregator_creator import create_server_aggregator
    from fedml_tpu_torch.ml.trainer.trainer_creator import create_model_trainer

    jmodel, jvars, tmodel, tvars = _models(model)
    dataset = HEADS[model][0]
    j, t = _both(_config(dataset, model, synthetic_train_size=160))
    ds, _ = fedml_tpu_torch.data.data_loader.load(t)
    test_data = ds[3]
    if model == "gcn_nodeclf":
        assert test_data[1].shape == (32, 16)  # [B, N] node labels
    jtrainer, ttrainer = jcreate(jmodel, j), create_model_trainer(tmodel, t)
    assert type(ttrainer).__name__ == trainer == type(jtrainer).__name__
    jtrainer.set_model_params(jvars)
    ttrainer.set_model_params(tvars)
    want, got = jtrainer.test(test_data, None, j), ttrainer.test(test_data, None, t)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=key)
    aggregator = create_server_aggregator(tmodel, t)
    aggregator.set_model_params(tvars)
    got_agg = aggregator.test(test_data, None, t)
    jaggregator = jcreate_aggregator(jmodel, j)
    jaggregator.set_model_params(jvars)
    want_agg = jaggregator.test(test_data, None, j)
    assert sorted(got_agg) == sorted(want_agg)
    for key in want_agg:
        np.testing.assert_allclose(got_agg[key], want_agg[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_regression_tolerance_knob_moves_the_hits():
    from fedml_tpu_torch.ml.trainer.reg_trainer import ModelTrainerReg

    _, _, tmodel, tvars = _models("gcn_reg")
    _, t = _both(_config("freesolv", "gcn_reg"))
    x = _graphs(8)
    trainer = ModelTrainerReg(tmodel, t)
    trainer.set_model_params(tvars)
    with torch.no_grad():
        pred = tmodel(torch.from_numpy(x)).numpy()
    y = pred + np.linspace(-1.0, 1.0, 8, dtype=np.float32)[:, None]
    loose = trainer.test((x, y), None, t)
    t.regression_tolerance = 0.3
    tight = ModelTrainerReg(tmodel, t)
    tight.set_model_params(tvars)
    strict = tight.test((x, y), None, t)
    assert loose["test_total"] == strict["test_total"] == 8.0
    assert loose["test_correct"] > strict["test_correct"]
    np.testing.assert_allclose(loose["test_rmse"] ** 2 * 8, loose["test_loss"], rtol=1e-5)


# -- SpreadGNN's head rule ------------------------------------------------------------


def test_head_rule_matches_one_whole_segment():
    from fedml_tpu_torch.simulation.sp.spreadgnn.spreadgnn_api import (
        _is_local_head, head_names_from)

    heads = head_names_from(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(CONFIG)))
    assert heads == ("readout",)
    assert _is_local_head("readout.weight", heads) and _is_local_head("readout.bias", heads)
    assert not _is_local_head("readout2.weight", heads)
    assert not _is_local_head("gc0.weight", heads)
    assert _is_local_head("block.readout.bias", heads)
    assert _is_local_head("node_head.weight", ("node_head", "reg_head"))
