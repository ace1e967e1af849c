"""The ``sp`` zoo's hooks and its members' own contracts, on the port.

* The refusals: every member x hook pair that the member's JAX twin skips
  silently (the table of ``fedml_tpu_torch/simulation/sp/__init__.py``;
  ``test_torch_sp_zoo.py`` reads the same table off the JAX runs) raises
  ``NotImplementedError`` when the member is built, naming the member and
  the hook; so does FedSGD on a dataset whose loss is not the CE.
* FedBuff under full participation, a buffer of the cohort, staleness 0 and
  the ``constant`` policy is bit-identical to the port's ``FedAvgAPI``.
* FedNova's taus are the trainer's recorded steps (the JAX oracle
  ``test_fednova_uses_step_counts``; its pairing with the updates is held
  to the JAX twin's in ``test_torch_sp_zoo.py``).
* Turbo-Aggregate's own masks (a CPU generator) telescope to the weighted
  mean within 1e-4 (the JAX oracle
  ``test_turbo_aggregate_matches_fedavg_modulo_masks``).
* ``tree_stack`` / ``tree_unstack`` and ``UpdateBuffer`` against their JAX
  twins.
* A kernel module end to end: SCAFFOLD and FedSGD on a tiny TransformerLM
  (2 layers, d_model 32; the port's attention kernels run as their plain
  versions on the CPU, JAX's model attends through its reference), 2
  rounds, global params after each within 5e-5 of the JAX twin's.
"""

import numpy as np
import pytest
import torch

import fedml_tpu_torch
import test_torch_sp_simulator as _sp
from fedml_tpu.models.transformer import TransformerConfig as JCfg, TransformerLM as JLM
from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM
import test_torch_sp_zoo as _zoo
from fedml_tpu_torch.simulation.sp import create_sp_algorithm
from fedml_tpu_torch.simulation.sp.fedavg.fedavg_api import (AFTER_DEFENSE, BEFORE_DEFENSE,
                                                             CENTRAL_DP, DATA_POISONING,
                                                             LOCAL_DP, MODEL_ATTACK,
                                                             ON_DEFENSE)

HOOK_KNOBS = {
    MODEL_ATTACK: {"enable_attack": True, "attack_type": "byzantine", "attack_mode": "zero",
                   "byzantine_client_num": 1},
    DATA_POISONING: {"enable_attack": True, "attack_type": "label_flipping",
                     "original_class": 1, "target_class": 7, "byzantine_client_num": 1},
    BEFORE_DEFENSE: {"enable_defense": True, "defense_type": "krum",
                     "byzantine_client_num": 1},
    ON_DEFENSE: {"enable_defense": True, "defense_type": "coordinate_wise_median"},
    AFTER_DEFENSE: {"enable_defense": True, "defense_type": "weak_dp"},
    LOCAL_DP: {"enable_dp": True, "dp_type": "ldp", "mechanism_type": "gaussian",
               "epsilon": 50.0},
    CENTRAL_DP: {"enable_dp": True, "dp_type": "cdp", "mechanism_type": "laplace",
                 "epsilon": 50.0},
}
# the hooks each member's JAX twin skips silently
SKIPPED = {
    "FedOpt": (ON_DEFENSE,),
    "FedNova": (ON_DEFENSE,),
    "FedSGD": (LOCAL_DP, ON_DEFENSE),
    "SCAFFOLD": (LOCAL_DP,),
    "FedDyn": (LOCAL_DP, ON_DEFENSE),
    "AsyncFedAvg": (MODEL_ATTACK, DATA_POISONING, BEFORE_DEFENSE, ON_DEFENSE),
    "FedBuff": (DATA_POISONING,),
    "HierarchicalFL": (MODEL_ATTACK, DATA_POISONING, BEFORE_DEFENSE, ON_DEFENSE),
    "decentralized": (MODEL_ATTACK, DATA_POISONING, BEFORE_DEFENSE, ON_DEFENSE,
                      AFTER_DEFENSE, CENTRAL_DP),
    "TurboAggregate": (MODEL_ATTACK, BEFORE_DEFENSE, ON_DEFENSE),
}
REFUSALS = [(m, h) for m in sorted(SKIPPED) for h in SKIPPED[m]]


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


@pytest.fixture(scope="module")
def lr_data():
    args = fedml_tpu_torch.Arguments.from_dict(_sp._config(_sp.LR_CONFIG))
    dataset, classes = fedml_tpu_torch.data.load(args)
    return dataset, fedml_tpu_torch.models.hub.create(args, classes)


def _build(lr_data, member, **knobs):
    config = _sp._config(_sp.LR_CONFIG, **_zoo.MEMBERS[member], **knobs)
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    dataset, model = lr_data
    return create_sp_algorithm(str(args.federated_optimizer), args, torch.device("cpu"),
                               dataset, model)


def test_the_table_is_each_class_s_skipped_hooks(lr_data):
    for member in _zoo.MEMBERS:
        api = _build(lr_data, member)
        assert type(api).__name__ == _zoo.CLASSES[member]
        assert tuple(type(api).SKIPPED_HOOKS) == SKIPPED.get(member, ()), member


@pytest.mark.parametrize("member,hook", REFUSALS)
def test_member_refuses_the_hook_its_jax_twin_skips(lr_data, member, hook):
    with pytest.raises(NotImplementedError,
                       match=f"{_zoo.CLASSES[member]} does not run the {hook} hook"):
        _build(lr_data, member, **HOOK_KNOBS[hook])


@pytest.mark.parametrize("dataset,model,loss", [
    ("stackoverflow_lr", "lr", "bce"), ("squad_span", "transformer_span", "span"),
    ("synthetic_s2s", "transformer_s2s", "s2s"),
])
def test_fedsgd_refuses_a_loss_other_than_ce(dataset, model, loss):
    """FedSGD's gradient is of the CE loss in both packages; the JAX twin
    takes it of span, seq2seq (-1) and multi-hot labels alike, the port
    refuses those datasets when the member is built, naming the loss."""
    config = _sp._config(_sp.LR_CONFIG, federated_optimizer="FedSGD")
    config["data_args"].update(dataset=dataset, partition_method="homo",
                               synthetic_train_size=32)
    config["model_args"]["model"] = model
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    dataset_t, classes = fedml_tpu_torch.data.load(args)
    with pytest.raises(NotImplementedError, match=f"trains with the {loss} loss"):
        create_sp_algorithm("FedSGD", args, torch.device("cpu"), dataset_t,
                            fedml_tpu_torch.models.hub.create(args, classes))


# -- FedBuff's equivalence ---------------------------------------------------------


def test_fedbuff_is_bit_identical_to_fedavg_in_the_equivalence_configuration():
    sync = _sp._config(_sp.LR_CONFIG, **_sp.TRUST)
    fedbuff = _sp._config(sync, fl_mode="async", async_buffer_size=8, async_max_staleness=0,
                          async_staleness_policy="constant")
    slog, sapi = _zoo.port_run(sync)
    _sp._reset_singletons()
    alog, aapi = _zoo.port_run(fedbuff)
    assert type(sapi).__name__ == "FedAvgAPI" and type(aapi).__name__ == "FedBuffAPI"
    assert sorted(alog["trained"]) == sorted(slog["trained"]) and len(alog["states"]) == 2
    assert [f["staleness"] for f in aapi.flush_log] == [[0] * 8] * 2
    for a, s in zip(alog["states"], slog["states"]):
        for k in s:
            assert a[k].tobytes() == s[k].tobytes(), k
    assert alog["evals"] == slog["evals"]


# -- FedNova ---------------------------------------------------------------------------


def test_fednova_taus_are_the_trainer_steps(lr_data):
    api = _build(lr_data, "FedNova")
    steps = []
    train = api.trainer.train

    def recorded(*a, **k):
        result = train(*a, **k)
        steps.append(float(result.steps))
        return result

    api.trainer.train = recorded
    api.train()
    assert len(api._round_taus) == int(api.args.client_num_per_round)
    assert all(t >= 1 for t in api._round_taus)
    assert api._round_taus == steps[-4:] == [2.0] * 4  # epochs 2, one batch each


# -- Turbo-Aggregate's own masks ------------------------------------------------------


def test_turbo_aggregate_telescopes_to_the_weighted_mean(lr_data):
    from fedml_tpu_torch.core.aggregate import weighted_mean

    api = _build(lr_data, "TurboAggregate")  # ta_group_num 3
    ups = [(2.0 + i, {k: v + i for k, v in api.w_global.items()}) for i in range(4)]
    got = api.server_update(list(ups))
    want = weighted_mean(ups)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-4)
    # the masks are unit normals, and the next round draws new ones
    first = api.draw_masks(api.w_global, 1)[0]
    again = api.draw_masks(api.w_global, 1)[0]
    flat = torch.cat([v.ravel() for v in first.values()])
    assert abs(float(flat.std()) - 1.0) < 0.05
    assert not any(torch.equal(first[k], again[k]) for k in first)


# -- the core helpers against their JAX twins -------------------------------------


def test_tree_stack_and_unstack_match_jax():
    from fedml_tpu.core.aggregate import tree_stack as jstack, tree_unstack as junstack
    from fedml_tpu_torch.core.aggregate import tree_stack, tree_unstack

    rng = np.random.RandomState(0)
    trees = [{"a": rng.randn(3, 2).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
             for _ in range(5)]
    got = tree_stack([{k: torch.from_numpy(v) for k, v in t.items()} for t in trees])
    want = jstack(trees)
    for k in want:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes()
    for g, w in zip(tree_unstack(got, 5), junstack(want, 5)):
        assert all(np.array_equal(g[k].numpy(), np.asarray(w[k])) for k in w)
    with pytest.raises(ValueError, match="tree 1 leaf 'a'"):
        tree_stack([{"a": torch.zeros(2)}, {"a": torch.zeros(3)}])


def test_update_buffer_matches_jax():
    from fedml_tpu.core.async_fl import UpdateBuffer as JBuffer
    from fedml_tpu_torch.core.async_fl import UpdateBuffer

    adds = [(5, 10.0, 2, 1), (2, 4.0, 1, 2), (7, 8.0, 1, 0)]
    for policy in ("constant", "polynomial", "hinge"):
        port, ref = UpdateBuffer(3, policy, 0.5, 1), JBuffer(3, policy, 0.5, 1)
        for sender, n, version, staleness in adds:
            params = {"w": np.full(4, sender, np.float32)}
            port.add(sender, {"w": torch.from_numpy(params["w"])}, n, version, staleness)
            ref.add(sender, params, n, version, staleness)
        assert port.ready() and port.approx_bytes == ref.approx_bytes == 48
        pe, re_ = port.drain(), ref.drain()
        assert [e.sender for e in pe] == [e.sender for e in re_] == [2, 7, 5]
        assert [w for w, _ in port.weighted(pe)] == [w for w, _ in ref.weighted(re_)]
        assert UpdateBuffer.staleness_stats(pe) == JBuffer.staleness_stats(re_)
        with pytest.raises(ValueError, match="already buffered"):
            port.add(1, {}, 1.0, 0, 0)
            port.add(1, {}, 1.0, 0, 0)


# -- the tiny TransformerLM (K1-K3 as their plain versions) --------------------------


@pytest.mark.parametrize("name", sorted(_zoo.NWP_MEMBERS))
def test_member_on_the_transformer_matches_its_jax_twin(name):
    config = _sp._config(_sp.NWP_CONFIG, **_zoo.NWP_MEMBERS[name])
    jlog, _, init, _ = _zoo.jax_run(config, JLM(JCfg(**_zoo.NWP_CFG)))
    _sp._reset_singletons()
    tlog, tapi = _zoo.port_run(config, init, TransformerLM(TransformerConfig(**_zoo.NWP_CFG),
                                                      device="meta"))
    assert type(tapi).__name__ == _zoo.CLASSES[name]
    assert tlog["trained"] == jlog["trained"]
    _sp._assert_states_close(tlog["states"], jlog["states"], 5e-5, name)
    _sp._assert_evals_close(tlog["evals"], jlog["evals"])
