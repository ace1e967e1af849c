"""The ``sp`` zoo: the port's members of ``simulation/sp`` (FedProx, FedOpt,
FedNova, FedSGD, SCAFFOLD, FedDyn, AsyncFedAvg, FedBuff, HierarchicalFL,
decentralized, Turbo-Aggregate) through ``init`` -> ``data.load`` ->
``models.hub.create`` -> ``FedMLRunner``, against their JAX twins on the
same configs.

Both sides start from the JAX init, transplanted, and take one full batch
per epoch (``lr`` on synthetic mnist, 8 clients, 4 a round, ``batch_size``
64), where the engines' different shuffles cannot matter.  Every global
model a member sets (each round, update or flush) must agree with the JAX
twin's within 2e-5, and the clients trained, in order, must be the same
(the cohorts, AsyncFedAvg's and FedBuff's event order, HierarchicalFL's
choices, decentralized's nodes), as must the groups, the topology and the
simulated durations, bit for bit.  Turbo-Aggregate takes the JAX run's
masks through the port's ``server_update``.  FedNova pairs its taus with
the updates by object identity as its JAX twin does, under krum (which
keeps the updates it picks) and norm clipping (which rebuilds them): 8 of 8
clients, 2 rounds, each client's tau set to ``1 + id % 3`` on both sides so
that a lost pairing shows, global params within 2e-5.  Where a FedBuff
client reports twice in one cycle, the JAX twin raises and the port drops
the second report.

The member x hook table of ``fedml_tpu_torch/simulation/sp/__init__.py`` is
read off the JAX runs: each JAX twin's calls of the aggregator's three
hooks, the trainer's after-hook (local DP) and the round loop's poisoning
check are counted, and the hooks it never calls must be the port class's
``SKIPPED_HOOKS``.  The refusals, FedBuff's equivalence to ``FedAvgAPI``,
FedNova's taus, Turbo-Aggregate's own masks and SCAFFOLD and FedSGD on the
tiny TransformerLM are in ``test_torch_sp_zoo_hooks.py``.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
import test_torch_sp_simulator as _sp
from fedml_tpu_torch.models import convert
from fedml_tpu_torch.simulation.sp.fedavg import fedavg_api as port_fedavg

# each member's knobs on _sp.LR_CONFIG (8 clients, 4 a round, 3 rounds)
MEMBERS = {
    "FedProx": {"federated_optimizer": "FedProx", "proximal_mu": 0.1},
    "FedOpt": {"federated_optimizer": "FedOpt", "server_optimizer": "adam", "server_lr": 0.03},
    "FedNova": {"federated_optimizer": "FedNova", "epochs": 2},
    "FedSGD": {"federated_optimizer": "FedSGD"},
    "SCAFFOLD": {"federated_optimizer": "SCAFFOLD", "epochs": 2},
    "FedDyn": {"federated_optimizer": "FedDyn", "feddyn_alpha": 0.1},
    "AsyncFedAvg": {"federated_optimizer": "Async_FedAvg", "comm_round": 6},
    "FedBuff": {"fl_mode": "async", "async_buffer_size": 2, "async_max_staleness": 1,
                "async_staleness_policy": "polynomial"},
    "HierarchicalFL": {"federated_optimizer": "HierarchicalFL", "group_num": 2,
                       "group_comm_round": 2},
    "decentralized": {"federated_optimizer": "decentralized_fl", "comm_round": 2},
    "TurboAggregate": {"federated_optimizer": "turbo_aggregate", "ta_group_num": 3},
}
CLASSES = {"FedProx": "FedProxAPI", "FedOpt": "FedOptAPI", "FedNova": "FedNovaAPI",
           "FedSGD": "FedSGDAPI", "SCAFFOLD": "ScaffoldAPI", "FedDyn": "FedDynAPI",
           "AsyncFedAvg": "AsyncFedAvgAPI", "FedBuff": "FedBuffAPI",
           "HierarchicalFL": "HierarchicalFLAPI", "decentralized": "DecentralizedFLAPI",
           "TurboAggregate": "TurboAggregateAPI"}
NWP_CFG = dict(_sp.CFG, n_layers=2)
NWP_MEMBERS = {"SCAFFOLD": {"federated_optimizer": "SCAFFOLD"},
               "FedSGD": {"federated_optimizer": "FedSGD"}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread, so the suite's parallel workers do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_singletons():
    yield
    _sp._reset_singletons()


def _instrument(api, to_numpy):
    """Record every global model the member sets, the clients it trains (in
    order) and its eval dicts."""
    log = {"states": [], "trained": [], "evals": []}
    agg, test = api.aggregator, api._test_global
    set_params = agg.set_model_params

    def set_model_params(v):
        log["states"].append(to_numpy(v))
        set_params(v)

    def test_global(round_idx):
        out = test(round_idx)
        log["evals"].append(out)
        return out

    for slot in api.client_list:
        def update(cid, *a, _orig=slot.update_local_dataset):
            log["trained"].append(int(cid))
            return _orig(cid, *a)

        slot.update_local_dataset = update
    agg.set_model_params, api._test_global = set_model_params, test_global
    return log


def _jax_key(trainer, padded_n, batch_size):
    """The shared-function key of ``_sp``, told apart by the grad hook."""
    hook = trainer.grad_hook
    return (*_sp._jax_train_key(trainer, padded_n, batch_size),
            getattr(hook, "__qualname__", None), str(getattr(trainer.args, "feddyn_alpha", None)))


def jax_run(config, model=None, before=None):
    """The JAX twin's run: (log, hook calls, init variables, API).  ``before``
    (api) runs after the API is built, before it trains."""
    from fedml_tpu.core.alg_frame.client_trainer import ClientTrainer
    from fedml_tpu.core.alg_frame.server_aggregator import ServerAggregator
    from fedml_tpu.core.security.fedml_attacker import FedMLAttacker
    from fedml_tpu.ml.aggregator import default_aggregator as jdefault_aggregator
    from fedml_tpu.ml.trainer.cls_trainer import ModelTrainerCLS as JTrainer
    from fedml_tpu.simulation.sp.fedavg import fedavg_api as jfedavg_api

    fn_for, make_eval_fn = JTrainer._fn_for, jdefault_aggregator.make_eval_fn
    fns = _sp._JAX_FNS

    def shared_fn_for(trainer, padded_n, batch_size):
        key = _jax_key(trainer, padded_n, batch_size)
        if key not in fns:
            fns[key] = fn_for(trainer, padded_n, batch_size)
        return fns[key]

    calls = dict.fromkeys(("on_before_aggregation", "aggregate", "on_after_aggregation",
                           "on_after_local_training", "is_data_poisoning_attack"), 0)

    def counted(cls, name):
        orig = getattr(cls, name)

        def wrapper(self, *a, **k):
            calls[name] += 1
            return orig(self, *a, **k)

        return wrapper

    args = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(config)),
                          should_init_logs=False)
    dataset, classes = fedml_tpu.data.data_loader.load(args)
    model = model if model is not None else fedml_tpu.models.hub.create(args, classes)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfedavg_api, "init_variables", lambda module, sample, seed=0: dict(
            fns.setdefault(("init", repr(module)), jax.jit(
                lambda k, s: module.init(k, s, train=False)))(jax.random.PRNGKey(seed), sample)))
        mp.setattr(jdefault_aggregator, "make_eval_fn",
                   lambda module: fns.setdefault(("eval", repr(module)), make_eval_fn(module)))
        mp.setattr(JTrainer, "_fn_for", shared_fn_for)
        for cls, names in ((ServerAggregator, ("on_before_aggregation", "aggregate",
                                               "on_after_aggregation")),
                           (ClientTrainer, ("on_after_local_training",)),
                           (FedMLAttacker, ("is_data_poisoning_attack",))):
            for name in names:
                mp.setattr(cls, name, counted(cls, name))
        runner = fedml_tpu.FedMLRunner(args, fedml_tpu.device.get_device(args), dataset, model)
        api = runner.runner.fl_trainer
        init = jax.tree_util.tree_map(np.asarray, api.w_global)
        log = _instrument(api, lambda v: convert.state_from_flax(
            jax.tree_util.tree_map(np.asarray, v)))
        if before is not None:
            before(api)
        log["final"] = runner.run()
    return log, calls, init, api


def port_run(config, init=None, model=None, before=None):
    """The port's run from ``init`` (flax variables) when given: (log, API)."""
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)),
                                should_init_logs=False)
    device = fedml_tpu_torch.device.get_device(args)
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = model if model is not None else fedml_tpu_torch.models.hub.create(args, classes)
    runner = fedml_tpu_torch.FedMLRunner(args, device, dataset, model)
    api = runner.runner.fl_trainer
    if init is not None:
        api.w_global = convert.variables_from_flax(init, model, device)
        api.aggregator.set_model_params(api.w_global)
        # the members that took copies of the init when they were built
        if hasattr(api, "group_models"):
            api.group_models = [api.w_global] * len(api.group_models)
        if hasattr(api, "node_models"):
            api.node_models = [api.w_global] * len(api.node_models)
    log = _instrument(api, lambda v: {k: t.detach().cpu().numpy().copy() for k, t in v.items()})
    if before is not None:
        before(api)
    log["final"] = runner.run()
    return log, api


def _ta_masks(recorded):
    """Turbo-Aggregate: record the JAX run's masks (``_mask_like``), to feed
    through the port's ``draw_masks``."""
    from fedml_tpu.simulation.sp.turboaggregate import ta_api

    mask_like = ta_api._mask_like

    def recording(tree, key, scale=1.0):
        out = mask_like(tree, key, scale)
        recorded.append(convert.state_from_flax(jax.tree_util.tree_map(np.asarray, out)))
        return out

    return ta_api, "_mask_like", recording


_RUNS = {}


def zoo_run(name):
    """The JAX twin's and the port's run of member ``name``, once a module."""
    if name not in _RUNS:
        config = _sp._config(_sp.LR_CONFIG, **MEMBERS[name])
        masks = []
        with pytest.MonkeyPatch.context() as mp:
            if name == "TurboAggregate":
                mp.setattr(*_ta_masks(masks))
            jlog, calls, init, japi = jax_run(config)
        _sp._reset_singletons()

        def feed(api):
            def draw(like, n):
                out = [masks.pop(0) for _ in range(n)]
                return [{k: torch.from_numpy(m[k].copy()) for k in like} for m in out]

            api.draw_masks = draw

        tlog, tapi = port_run(config, init, before=feed if masks else None)
        _sp._reset_singletons()
        assert not masks  # every JAX mask went through the port
        _RUNS[name] = (jlog, calls, japi, tlog, tapi)
    return _RUNS[name]


# -- parity, lr -----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MEMBERS))
def test_member_matches_its_jax_twin(name):
    jlog, _, _, tlog, tapi = zoo_run(name)
    assert type(tapi).__name__ == CLASSES[name]
    assert tlog["trained"] == jlog["trained"] and tlog["trained"]
    _sp._assert_states_close(tlog["states"], jlog["states"], 2e-5, name)
    _sp._assert_evals_close(tlog["evals"], jlog["evals"])
    assert tlog["final"] == tlog["evals"][-1]


_SKIPPED_WHEN_UNCALLED = {
    "on_before_aggregation": (port_fedavg.MODEL_ATTACK, port_fedavg.BEFORE_DEFENSE),
    "aggregate": (port_fedavg.ON_DEFENSE,),
    "on_after_aggregation": (port_fedavg.AFTER_DEFENSE, port_fedavg.CENTRAL_DP),
    "on_after_local_training": (port_fedavg.LOCAL_DP,),
    "is_data_poisoning_attack": (port_fedavg.DATA_POISONING,),
}


@pytest.mark.parametrize("name", sorted(MEMBERS))
def test_member_skips_the_hooks_its_jax_twin_skips(name):
    _, calls, _, _, tapi = zoo_run(name)
    skipped = {h for call, hooks in _SKIPPED_WHEN_UNCALLED.items() if not calls[call]
               for h in hooks}
    assert set(type(tapi).SKIPPED_HOOKS) == skipped, calls


def test_hierarchical_groups_and_choices_are_identical():
    _, _, japi, tlog, tapi = zoo_run("HierarchicalFL")
    assert [g.tolist() for g in tapi.groups] == [g.tolist() for g in japi.groups]
    assert [c for r in tapi.chosen for g in r for c in g] == tlog["trained"]
    assert len(tapi.chosen) == 3 and all(len(r) == 2 and len(r[0]) == 2 for r in tapi.chosen)
    # group-only rounds set no global model: one global average (round 1)
    assert len(tlog["states"]) == 1


def test_topology_is_bit_identical():
    from fedml_tpu.core.distributed.topology.topology_manager import (
        AsymmetricTopologyManager as JAsym, SymmetricTopologyManager as JSym)
    from fedml_tpu_torch.core.distributed.topology.topology_manager import (
        AsymmetricTopologyManager, SymmetricTopologyManager)

    _, _, japi, _, tapi = zoo_run("decentralized")
    assert tapi.topo.topology.tobytes() == japi.topo.topology.tobytes()
    assert tapi.mix.numpy().tobytes() == np.asarray(japi.mix).tobytes()
    for n, k, seed in ((8, 4, 0), (16, 5, 3), (5, 2, 1)):
        for port, ref in ((SymmetricTopologyManager, JSym), (AsymmetricTopologyManager, JAsym)):
            a, b = port(n, k, seed=seed), ref(n, k, seed=seed)
            a.generate_topology()
            b.generate_topology()
            assert a.topology.tobytes() == b.topology.tobytes()
            assert a.get_in_neighbor_idx_list(1) == b.get_in_neighbor_idx_list(1)
            assert a.get_out_neighbor_idx_list(2) == b.get_out_neighbor_idx_list(2)


def test_decentralized_consensus_is_the_mean_of_the_nodes():
    _, _, _, tlog, tapi = zoo_run("decentralized")
    assert tlog["trained"] == list(range(8)) * 2
    for k, v in tapi.w_global.items():
        mean = torch.stack([m[k] for m in tapi.node_models]).mean(dim=0)
        assert torch.equal(v, mean), k


@pytest.mark.parametrize("name", ["AsyncFedAvg", "FedBuff"])
def test_simulated_durations_are_bit_identical(name):
    _, _, japi, tlog, tapi = zoo_run(name)
    assert tapi.durations.tobytes() == japi.durations.tobytes()
    assert len(tapi.round_times) == int(MEMBERS[name].get("comm_round", 3))


def test_fedbuff_flushes():
    _, _, _, tlog, tapi = zoo_run("FedBuff")
    assert [f["n_deltas"] for f in tapi.flush_log] == [2, 2, 2]
    assert all(s <= 1 for f in tapi.flush_log for s in f["staleness"])
    assert any(s == 1 for f in tapi.flush_log for s in f["staleness"])


def test_fedbuff_drops_a_second_report_where_its_jax_twin_raises():
    """16 clients, 8 a round, a buffer of 4, staleness up to 2: client 14
    reports twice before a flush.  The JAX twin's buffer raises on the
    duplicate sender; the port drops the second report."""
    config = _sp._config(_sp.LR_CONFIG, fl_mode="async", client_num_in_total=16,
                         client_num_per_round=8, async_buffer_size=4, async_max_staleness=2,
                         async_staleness_policy="polynomial", comm_round=4)
    with pytest.raises(ValueError, match="sender 14 already buffered"):
        jax_run(config)
    _sp._reset_singletons()
    _, api = port_run(config)
    flushes = api.flush_log
    assert len(flushes) == 4 and flushes[-1]["dropped_dup"] >= 1
    assert all(len(set(f["senders"])) == 4 for f in flushes)


# -- FedNova's tau pairing under the before-stage defenses --------------------------


def _uneven_taus(api):
    api._collect_tau = lambda: float(1 + int(api.trainer.id) % 3)


@pytest.mark.parametrize("defense", [
    {"defense_type": "krum", "byzantine_client_num": 2},
    {"defense_type": "norm_diff_clipping", "norm_bound": 0.05},
])
def test_fednova_pairs_taus_as_its_jax_twin(defense):
    config = _sp._config(_sp.LR_CONFIG, **MEMBERS["FedNova"], **_sp.TRUST,
                         enable_defense=True, **defense)
    kept = {"jax": [], "port": []}

    def record_kept(side):
        def before(api):
            _uneven_taus(api)
            hook = api.aggregator.on_before_aggregation

            def on_before(w_locals):
                out = hook(w_locals)
                ids = {id(w) for _, w in w_locals}
                kept[side].append([id(w) in ids for _, w in out])
                return out

            api.aggregator.on_before_aggregation = on_before

        return before

    jlog, _, init, _ = jax_run(config, before=record_kept("jax"))
    _sp._reset_singletons()
    tlog, _ = port_run(config, init, before=record_kept("port"))
    assert kept["port"] == kept["jax"] and len(kept["port"]) == 2
    # krum keeps the objects it picks, clipping rebuilds every one
    want = defense["defense_type"] == "krum"
    assert all(k == want for r in kept["port"] for k in r)
    _sp._assert_states_close(tlog["states"], jlog["states"], 2e-5, defense["defense_type"])
