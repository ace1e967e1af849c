"""The in-mesh hierarchical and Turbo-Aggregate rounds of the port
(``backend: XLA``: ``HierarchicalInMeshAPI``, ``TurboAggregateInMeshAPI``)
against their JAX twins on a one-device mesh and against the port's ``sp``
twins, ``lr`` on mnist, from the same initial weights.

* Against JAX: one full batch a client (``batch_size`` 512 over a hetero
  split, so the engines' different shuffles cannot matter), SGD.
  Hierarchical: 8 clients in 2 groups, 4 a round, a global sync every 2 of 3
  rounds (the last round leaves the groups apart): the global model and
  each group's within 2e-5, the groups and draws equal, the eval dicts
  within 2e-4 (both round to 4 decimals).  Turbo-Aggregate: 8 clients, 6 a
  round in 3 groups, 2 rounds, JAX's masks fed through ``draw_masks`` (the
  key chain of the JAX round replayed): the global model within the ring's
  rounding bound below.
* Against the port's ``sp`` twins, which the in-mesh rounds subclass with
  only the clients' padding changed: equal clients of 64 rows in batches of
  16, so the ``sp`` trainer's bucket and ``padded_n`` agree, both train the
  same batches and every tree is equal bit for bit (the JAX package's bar
  for this pair, ``tests/test_xla_hierarchical.py``, is rtol 1e-5, atol
  1e-6); Turbo-Aggregate's twins draw the same masks from the same
  generator.
* The ring's bound: each of the 4L + 1 fp32 operations on a coordinate
  (scale, add m_g, take off m_{g-1}, accumulate; the last unmask) rounds by
  at most 2^-24 of an operand no larger than 2 max|m| + max|p|, on either
  side: 2 (4L + 1) 2^-24 (2 max|m| + max|p|), with the masks unit normals.
* Each refuses the trust hooks its JAX twin skips (all but the
  after-aggregation defense and central DP, which it runs) and runs without
  an eval at ``frequency_of_the_test: 0``; both ``xla_*`` example configs
  run as they stand.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
import test_torch_sp_simulator as _sp
import test_torch_sp_zoo_hooks as _hooks
import test_torch_structural_sp as _st
from fedml_tpu_torch.models import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# the hooks the JAX rounds run: on_after_aggregation's
RUNS = {"after-aggregation defense", "central DP"}


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


def _config(optimizer, homo=False, **train):
    config = copy.deepcopy(_sp.LR_CONFIG)
    config["data_args"].update(synthetic_train_size=512,
                               partition_method="homo" if homo else "hetero")
    config["train_args"].update(federated_optimizer=optimizer, client_num_in_total=8,
                                learning_rate=0.1, batch_size=16 if homo else 512, **train)
    config["comm_args"]["backend"] = "XLA"
    return config


HIER = dict(client_num_per_round=4, comm_round=3, group_num=2, group_comm_round=2)
TURBO = dict(client_num_per_round=6, comm_round=2, ta_group_num=3)


def _jax_api(config, cls_name):
    from fedml_tpu.parallel.mesh import create_fl_mesh
    from fedml_tpu.simulation.xla import hierarchical, turbo

    cls = getattr(hierarchical if cls_name == "HierarchicalInMeshAPI" else turbo, cls_name)
    args = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(config)),
                          should_init_logs=False)
    dataset, classes = fedml_tpu.data.data_loader.load(args)
    model = fedml_tpu.models.hub.create(args, classes)
    return cls(args, None, dataset, model, mesh=create_fl_mesh(devices=jax.devices()[:1]))


def _port(config, backend="XLA"):
    """(runner, API) of the port through the entry points."""
    config = copy.deepcopy(config)
    config["comm_args"]["backend"] = backend
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, classes)
    runner = fedml_tpu_torch.FedMLRunner(args, CPU, dataset, model)
    return runner, getattr(runner.runner, "fl_trainer", None) or runner.runner.sim


def _np(tree):
    return convert.state_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _close(got, want, atol, rtol=0.0):
    assert sorted(got) == sorted(want)
    for k in want:
        w = want[k].detach().numpy() if torch.is_tensor(want[k]) else want[k]
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=rtol, atol=atol, err_msg=k)


def _evals_close(got, want):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert g["round"] == w["round"]
        for key in ("test_acc", "test_loss"):
            assert abs(g[key] - w[key]) <= 2e-4, (key, g, w)


def _ring_bound(masks, params, groups) -> float:
    top = max(float(m[k].abs().max()) for m in masks for k in m)
    return 2 * (4 * groups + 1) * 2.0 ** -24 * (2 * top + max(
        float(v.abs().max()) for v in params.values()))


# -- hierarchical -----------------------------------------------------------------------


def test_hierarchical_matches_jax():
    config = _config("HierarchicalFL", **HIER)
    japi = _jax_api(config, "HierarchicalInMeshAPI")
    runner, api = _port(config)
    assert type(api).__name__ == "HierarchicalInMeshAPI" and api.padded_n == japi.padded_n
    assert [list(g) for g in api.groups] == [list(g) for g in japi.groups]
    init = convert.variables_from_flax(jax.tree_util.tree_map(np.asarray, japi.w_global),
                                       api.module, CPU)
    api.w_global, api.group_models = init, [init] * 2
    api.aggregator.set_model_params(init)
    jfinal, final = japi.train(), runner.run()
    assert [sum(groups, []) for groups in api.chosen] == [
        [int(c) for c in japi._sample_round(r)] for r in range(3)]
    _close(api.w_global, _np(japi.w_global), 2e-5)
    for g in range(2):
        _close(api.group_models[g], _np(japi.group_model(g)), 2e-5)
    assert any(not torch.equal(api.group_models[0][k], api.group_models[1][k])
               for k in api.w_global)  # round 2 is past the last sync
    _evals_close(api.eval_history, japi.eval_history)
    assert final == api.eval_history[-1] and jfinal["round"] == final["round"] == 2


def test_hierarchical_matches_its_sp_twin():
    config = _config("HierarchicalFL", homo=True, **HIER)
    sp_runner, sp = _port(config, "sp")
    sp_final = sp_runner.run()
    _sp._reset_singletons()
    runner, api = _port(config)
    assert api.padded_n == sp.trainer.padded_size(64, 16) == 64  # the same batches
    final = runner.run()
    for got, want in zip([api.w_global, *api.group_models], [sp.w_global, *sp.group_models]):
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert final == sp_final


# -- Turbo-Aggregate -------------------------------------------------------------------


def _jax_masks(japi, groups):
    """The JAX round's masks, replayed: ``split`` of the key chain seeded
    ``random_seed + 404`` into ``ta_group_num + 1`` a round, one mask tree a
    group key (``_mask_like`` over the variables' leaves)."""
    from fedml_tpu.simulation.sp.turboaggregate.ta_api import _mask_like

    state = {"key": jax.random.PRNGKey(int(japi.args.random_seed) + 404), "drawn": []}

    def draw(like, n):
        assert n == groups
        state["key"], *gkeys = jax.random.split(state["key"], groups + 1)
        masks = [{k: torch.from_numpy(v.copy()) for k, v in
                  _np(_mask_like(japi.variables, gkeys[g])).items()} for g in range(n)]
        state["drawn"].extend(masks)
        return masks

    return draw, state["drawn"]


def test_turbo_matches_jax():
    config = _config("turbo_aggregate", **TURBO)
    japi = _jax_api(config, "TurboAggregateInMeshAPI")
    runner, api = _port(config)
    assert type(api).__name__ == "TurboAggregateInMeshAPI" and api.group_num == 3
    init = convert.variables_from_flax(jax.tree_util.tree_map(np.asarray, japi.variables),
                                       api.module, CPU)
    api.w_global = init
    api.aggregator.set_model_params(init)
    api.draw_masks, drawn = _jax_masks(japi, 3)
    jfinal, final = japi.train(), runner.run()
    assert len(drawn) == 6
    _close(api.w_global, _np(japi.variables), _ring_bound(drawn, api.w_global, 3))
    _evals_close(api.eval_history, japi.eval_history)
    assert final["round"] == jfinal["round"] == 1


def test_turbo_matches_its_sp_twin():
    config = _config("turbo_aggregate", homo=True, **dict(TURBO, client_num_per_round=8))
    drawn = []

    def recording(api):
        draw = api.draw_masks
        api.draw_masks = lambda like, n: drawn.extend(draw(like, n)) or drawn[-n:]

    sp_runner, sp = _port(config, "sp")
    recording(sp)
    sp_final = sp_runner.run()
    _sp._reset_singletons()
    runner, api = _port(config)
    recording(api)
    final = runner.run()
    assert len(drawn) == 12  # 3 masks a round, 2 rounds, each twin
    for a, b in zip(drawn[:6], drawn[6:]):  # the same draws in the same order
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(api.w_global[k], sp.w_global[k]) for k in sp.w_global)
    assert final == sp_final


# -- hooks, frequency, the example configs -----------------------------------------------

MEMBERS = {"HierarchicalFL": "HierarchicalInMeshAPI", "turbo_aggregate": "TurboAggregateInMeshAPI"}


@pytest.mark.parametrize("hook", sorted(_hooks.HOOK_KNOBS))
@pytest.mark.parametrize("member", sorted(MEMBERS))
def test_inmesh_round_runs_only_the_after_aggregation_hooks(member, hook):
    config = _config(member, homo=True, client_num_per_round=4)
    config["train_args"].update(_hooks.HOOK_KNOBS[hook])
    if hook in RUNS:
        assert type(_port(config)[1]).__name__ == MEMBERS[member]
        return
    with pytest.raises(NotImplementedError, match=f"{MEMBERS[member]} does not run the .*{hook}"):
        _port(config)


@pytest.mark.parametrize("member", sorted(MEMBERS))
def test_frequency_zero_runs_without_an_eval(member):
    config = _config(member, homo=True, client_num_per_round=4, comm_round=2)
    config["validation_args"]["frequency_of_the_test"] = 0
    runner, api = _port(config)
    assert runner.run() == {} and api.eval_history == [] and len(api.round_losses) == 2


@pytest.mark.parametrize("name,cls", [("xla_hierarchical_fl_mnist_lr", "HierarchicalInMeshAPI"),
                                      ("xla_turbo_aggregate_mnist_lr",
                                       "TurboAggregateInMeshAPI")])
def test_example_config_runs_on_the_port(name, cls):
    final, api = _st.run_example(name)
    assert type(api).__name__ == cls and final["round"] == 1
    assert np.all(np.isfinite(api.round_losses)) and 0.0 <= final["test_acc"] <= 1.0
