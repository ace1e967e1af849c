"""The trust path through the simulator: attacks, defenses and DP on the padded
and the packed round, the port through ``init`` -> ``data.load`` ->
``models.hub.create`` -> ``FedMLRunner`` against the JAX package's
``XLASimulator`` on a one-device mesh.

Setup, as ``test_torch_zoo.py``: ``mnist`` (synthetic, 400 images,
Dirichlet(0.5) over 8 clients of 30-62 images), the ``lr`` model, SGD lr
0.05, 2 rounds; here every client takes part in every round (8 of 8), so
krum with one Byzantine client sums 5 distances a score and no near-tie
decides a selection.  Both sides start from the JAX init, transplanted.  The
padded round takes one full batch per epoch (batch 64), the packed round
batch 8 (the two stream the same batches).

The deterministic rules, end to end, must agree with JAX within atol 2e-5
after each round (global params): label flipping (pack-time) with krum on
both rounds, byzantine ``zero`` with the coordinate-wise median (8 rows:
the even-n median) under AsyncFedAvg (rows mode) on the packed round, and
FedNova with model replacement and foolsgold (rows mode, ``ext_from_rows``,
the history carried across rounds) on both rounds.  Each JAX run compiles
its rounds, so the cases are spread over the two rounds rather than
crossed with them.  ``ext_from_rows`` of FedNova, AsyncFedAvg and FedBuff
is held to JAX's on its own, with a selection's zero weights.  Every zoo
member runs under an attack, a defense and local DP on both rounds.  The malicious set
and the poisoned clients must be ``get_byzantine_idxs``'s, as in JAX.

The random rules draw from torch generators, so they are held to replay
determinism (two runs of one seed, bitwise equal) and, for DP, to the noise's
scale: with lr 0 every client returns the global model, so local DP's
aggregate moves by sigma * sqrt(sum w_i^2) / sum w_i per coordinate and
central DP's by sigma (Gaussian) or scale * sqrt(2) (Laplace); the measured
standard deviation over the 7,850 coordinates must lie within 5 % of it
(the sampling error of a standard deviation over 7,850 draws is about
0.8 %).  With a huge epsilon both DP modes equal FedAvg (atol 1e-6).
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
from fedml_tpu_torch.core.security import defense_funcs as TF
from fedml_tpu_torch.models import convert

ATOL = 2e-5
ROUNDS = 2
CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "mnist", "partition_method": "hetero", "partition_alpha": 0.5,
                  "synthetic_train_size": 400},
    "model_args": {"model": "lr"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 8,
                   "client_num_per_round": 8, "comm_round": ROUNDS, "epochs": 1,
                   "client_optimizer": "sgd", "learning_rate": 0.05},
    "validation_args": {"frequency_of_the_test": 0},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "XLA"},
}
KINDS = {"padded": {"batch_size": 64}, "packed": {"batch_size": 8, "xla_pack": True}}
DETERMINISTIC = {
    "label_flipping_krum": {"enable_attack": True, "attack_type": "label_flipping",
                            "original_class": 1, "target_class": 7, "byzantine_client_num": 2,
                            "enable_defense": True, "defense_type": "krum"},
    "byzantine_zero_median": {"federated_optimizer": "Async_FedAvg", "enable_attack": True,
                              "attack_type": "byzantine", "attack_mode": "zero",
                              "byzantine_client_num": 2, "enable_defense": True,
                              "defense_type": "coordinate_wise_median"},
    "fednova_foolsgold": {"federated_optimizer": "FedNova", "enable_attack": True,
                          "attack_type": "model_replacement", "attack_scale": 5.0,
                          "byzantine_client_num": 2, "enable_defense": True,
                          "defense_type": "foolsgold"},
}


def _config(knobs, kind, **over):
    config = copy.deepcopy(CONFIG)
    config["train_args"].update(knobs, **KINDS[kind])
    config["train_args"].update(over)
    return config


def _reset_singletons():
    from fedml_tpu.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy as JDP
    from fedml_tpu.core.security.fedml_attacker import FedMLAttacker as JA
    from fedml_tpu.core.security.fedml_defender import FedMLDefender as JD
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
    from fedml_tpu_torch.core.security.fedml_attacker import FedMLAttacker
    from fedml_tpu_torch.core.security.fedml_defender import FedMLDefender

    JA._attacker_instance = JD._defender_instance = JDP._instance = None
    FedMLAttacker._attacker_instance = FedMLDefender._defender_instance = None
    FedMLDifferentialPrivacy._instance = None



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
    _reset_singletons()  # the singletons are process-global


def _port_params(variables):
    return {k: v.numpy().copy() for k, v in variables.items()}


def _port_run(config, init=None, before_run=None):
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)),
                                should_init_logs=False)
    device = fedml_tpu_torch.device.get_device(args)
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, classes)
    runner = fedml_tpu_torch.FedMLRunner(args, device, dataset, model)
    sim = runner.runner.sim
    if init is not None:
        sim.variables = convert.variables_from_flax(init, model, device)
    states = []
    sync = sim._sync

    def synced():  # once a round, after the server step and central DP
        sync()
        states.append(_port_params(sim.variables))

    sim._sync = synced
    if before_run is not None:
        before_run(sim)
    runner.run()
    return sim, states


def _run_pair(name, kind):
    config = _config(DETERMINISTIC[name], kind)
    jargs = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(config)),
                           should_init_logs=False)
    jdataset, classes = fedml_tpu.data.data_loader.load(jargs)
    jmodel = fedml_tpu.models.hub.create(jargs, classes)
    jsim = jfed_sim.XLASimulator(jargs, jdataset, jmodel,
                                 mesh=create_fl_mesh(devices=jax.devices()[:1]))
    init = jax.tree_util.tree_map(np.asarray, jsim.variables)
    jstates = []
    jround_end = jsim.algo.host_round_end

    def jended(*a):
        p = jax.tree_util.tree_map(np.asarray, jsim.variables)["params"]["linear"]
        jstates.append({"linear.weight": p["kernel"].T, "linear.bias": p["bias"]})
        return jround_end(*a)

    jsim.algo.host_round_end = jended
    from fedml_tpu.core.security.fedml_attacker import FedMLAttacker as JA

    jbad = JA.get_instance().get_byzantine_idxs(8)
    jy = np.asarray(jsim.y_all).copy()
    jsim.train()
    _reset_singletons()
    margins = []

    def record_krum_margins(sim):
        """The relative gap between the two lowest krum scores of each round:
        a near-tie would let roundoff decide the selection."""
        if sim._defense is None or sim._defense.t != "krum":
            return
        rows_fn = sim._defense.rows_fn

        def rows(mat, *a, **k):
            scores = torch.sort(TF.krum_scores(mat, sim._defense.byz)).values
            margins.append(float((scores[1] - scores[0]) / scores[1]))
            return rows_fn(mat, *a, **k)

        sim._defense.rows_fn = rows

    tsim, tstates = _port_run(config, init, before_run=record_krum_margins)
    return {"jstates": jstates, "tstates": tstates, "jbad": jbad, "jy": jy, "tsim": tsim,
            "margins": margins}


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name, kind):
        if (name, kind) not in cache:
            cache[(name, kind)] = _run_pair(name, kind)
            _reset_singletons()
        return cache[(name, kind)]

    return get


CASES = [("label_flipping_krum", "padded"), ("label_flipping_krum", "packed"),
         ("byzantine_zero_median", "packed"), ("fednova_foolsgold", "padded"),
         ("fednova_foolsgold", "packed")]


@pytest.mark.parametrize("name,kind", CASES)
def test_deterministic_rules_agree_with_jax_after_each_round(pairs, name, kind):
    run = pairs(name, kind)
    assert len(run["tstates"]) == len(run["jstates"]) == ROUNDS
    for r, (got, want) in enumerate(zip(run["tstates"], run["jstates"])):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                       err_msg=f"{name} {kind} round {r} {k}")
    assert all(np.isfinite(run["tsim"].round_losses))
    if DETERMINISTIC[name]["defense_type"] == "krum":
        assert len(run["margins"]) == ROUNDS and min(run["margins"]) > 1e-3, run["margins"]


@pytest.mark.parametrize("name,kind", CASES)
def test_malicious_and_poisoned_sets_are_get_byzantine_idxs(pairs, name, kind):
    run = pairs(name, kind)
    sim, bad = run["tsim"], run["jbad"]
    assert len(bad) == 2
    if DETERMINISTIC[name]["attack_type"] == "label_flipping":
        assert sim.poisoned_clients == bad
        # the packed labels of JAX and the port are the same, flipped rows too
        np.testing.assert_array_equal(sim.y_all.numpy(), run["jy"])
        assert sim.malicious_per_round == [[]] * ROUNDS  # no model attack
    else:
        assert sim.poisoned_clients == []
        assert sim.malicious_per_round == [bad] * ROUNDS


ZOO = {"FedAvg": {}, "FedProx": {"federated_optimizer": "FedProx", "proximal_mu": 0.1},
       "FedOpt": {"federated_optimizer": "FedOpt", "server_optimizer": "adam",
                  "server_lr": 0.05},
       "FedNova": {"federated_optimizer": "FedNova"},
       "SCAFFOLD": {"federated_optimizer": "SCAFFOLD"},
       "FedDyn": {"federated_optimizer": "FedDyn", "feddyn_alpha": 0.1},
       "AsyncFedAvg": {"federated_optimizer": "Async_FedAvg"},
       "FedBuff": {"fl_mode": "async", "async_buffer_size": 6, "async_max_staleness": 2}}


@pytest.mark.parametrize("member", sorted(ZOO))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_zoo_member_composes_with_the_trust_path(member, kind):
    knobs = dict(ZOO[member], enable_attack=True, attack_type="byzantine", attack_mode="flip",
                 byzantine_client_num=2, enable_defense=True, defense_type="multi_krum",
                 krum_param_m=4, enable_dp=True, dp_type="ldp", epsilon=100.0)
    sim, states = _port_run(_config(knobs, kind))
    assert len(states) == ROUNDS and all(np.isfinite(sim.round_losses))
    assert all(np.isfinite(v).all() for v in states[-1].values())
    assert len(sim.security_ms) == ROUNDS and sim.malicious_per_round == [[3, 6]] * ROUNDS


@pytest.mark.parametrize("member", ["FedNova", "AsyncFedAvg", "FedBuff"])
def test_ext_from_rows_matches_jax(member):
    """The ext strategies' rebuild from the defended rows, a selection's
    zero weights included, against JAX's on the same rows."""
    import jax.numpy as jnp

    from fedml_tpu.simulation.xla import algorithms as jalgorithms
    from fedml_tpu_torch.simulation.xla import algorithms as talgorithms

    args = fedml_tpu_torch.Arguments.from_dict(_config(ZOO[member], "packed"))
    jalgo, talgo = jalgorithms.create_inmesh_algorithm(args), \
        talgorithms.create_inmesh_algorithm(args)
    rng = np.random.RandomState(1)
    mat = rng.normal(1.0, 0.1, (6, 10)).astype(np.float32)
    g = rng.normal(1.0, 0.1, 10).astype(np.float32)
    w_orig = np.array([30, 41, 62, 35, 50, 44], np.float32)
    w = w_orig * np.array([1, 0, 1, 1, 0, 1], np.float32)
    meta = np.array([4, 6, 8, 5, 7, 6], np.float32) if member == "FedNova" else \
        np.array([0, 1, 2, 0, 3, 1], np.float32)
    want = jalgo.ext_from_rows(jnp.asarray(mat), jnp.asarray(w), jnp.asarray(w_orig),
                               jnp.asarray(meta), jnp.asarray(g), lambda v: {"v": v})
    got = talgo.ext_from_rows(torch.from_numpy(mat), torch.from_numpy(w),
                              torch.from_numpy(w_orig), meta, torch.from_numpy(g),
                              lambda v: {"v": v})
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(got[k], dict):
            np.testing.assert_allclose(got[k]["v"].numpy(), np.asarray(want[k]["v"]),
                                       rtol=1e-6, atol=1e-6)
        else:
            assert got[k] == pytest.approx(float(want[k]), rel=1e-6)


def test_fednova_foolsgold_keeps_its_history_across_rounds(pairs):
    sim = pairs("fednova_foolsgold", "packed")["tsim"]
    hist = sim._defense_state["fg_hist"]
    assert hist.shape == (8, 7850) and float(hist.abs().sum()) > 0


RANDOM = {
    "byzantine_random_krum": {"enable_attack": True, "attack_type": "byzantine",
                              "attack_mode": "random", "byzantine_client_num": 2,
                              "enable_defense": True, "defense_type": "multi_krum",
                              "krum_param_m": 3},
    "backdoor_alie_trimmed_mean": {"enable_attack": True, "attack_type": "backdoor",
                                   "byzantine_client_num": 2, "enable_defense": True,
                                   "defense_type": "coordinate_wise_trimmed_mean", "beta": 0.2},
    "weak_dp": {"enable_defense": True, "defense_type": "weak_dp", "stddev": 0.01},
    "wbc": {"enable_defense": True, "defense_type": "wbc", "wbc_strength": 0.5},
    "ldp_gaussian": {"enable_dp": True, "dp_type": "ldp", "mechanism_type": "gaussian",
                     "epsilon": 50.0},
    "cdp_laplace": {"enable_dp": True, "dp_type": "cdp", "mechanism_type": "laplace",
                    "epsilon": 50.0},
}


@pytest.mark.parametrize("name", sorted(RANDOM))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_random_rules_replay_bitwise(name, kind):
    finals = []
    for _ in range(2):
        sim, states = _port_run(_config(RANDOM[name], kind))
        _reset_singletons()
        finals.append(states)
    for a, b in zip(*finals):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), (name, kind, k)


def _delta_std(knobs, kind):
    """The std over coordinates of one lr-0 round's move of the global model,
    and the round's sample counts."""
    init = {}
    sim, states = _port_run(_config(knobs, kind, learning_rate=0.0, comm_round=1),
                            before_run=lambda sim: init.update(_port_params(sim.variables)))
    delta = np.concatenate([(states[0][k] - init[k]).ravel() for k in states[0]])
    counts = np.asarray([sim.local_num_dict[i] for i in range(8)], np.float64)
    return float(delta.std()), counts


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dp_type,mechanism", [("ldp", "gaussian"), ("ldp", "laplace"),
                                               ("cdp", "gaussian"), ("cdp", "laplace")])
def test_noise_scale_within_statistical_bound(kind, dp_type, mechanism):
    knobs = {"enable_dp": True, "dp_type": dp_type, "mechanism_type": mechanism,
             "epsilon": 2.0, "delta": 1e-5, "sensitivity": 0.01}
    got, counts = _delta_std(knobs, kind)
    from fedml_tpu_torch.core.dp.mechanisms import Gaussian

    scale = (Gaussian.compute_sigma(2.0, 1e-5, 0.01) if mechanism == "gaussian"
             else 0.01 / 2.0 * np.sqrt(2.0))  # a Laplace(b) draw has std b * sqrt(2)
    if dp_type == "ldp":
        scale *= np.sqrt((counts ** 2).sum()) / counts.sum()
    assert abs(got / scale - 1.0) < 0.05, (got, scale)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dp_type", ["ldp", "cdp"])
def test_zero_noise_equals_fedavg(kind, dp_type):
    _, plain = _port_run(_config({}, kind))
    _, noised = _port_run(_config({"enable_dp": True, "dp_type": dp_type,
                                   "mechanism_type": "gaussian", "epsilon": 1e12}, kind))
    for a, b in zip(plain, noised):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6)


def test_ldp_accounts_before_each_round_and_stops_at_its_budget():
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy

    knobs = {"enable_dp": True, "dp_type": "ldp", "mechanism_type": "gaussian",
             "epsilon": 1.0, "privacy_budget": 16.0}
    _port_run(_config(knobs, "packed"))  # 2 rounds x 8 clients x epsilon 1
    assert len(FedMLDifferentialPrivacy.get_instance().accountant) == 16
    with pytest.raises(RuntimeError, match="privacy budget exhausted"):
        _port_run(_config(knobs, "packed", comm_round=3))
    dp = FedMLDifferentialPrivacy.get_instance()
    assert len(dp.accountant) == 16 and dp.accountant.remaining[0] == pytest.approx(0.0)


@pytest.mark.parametrize("knobs,item", [
    ({"enable_attack": True, "attack_type": "dlg"}, "item 8:"),
    ({"enable_attack": True, "attack_type": "invert_gradient"}, "item 8:"),
    ({"enable_attack": True, "attack_type": "revealing_labels_from_gradients"}, "item 8:"),
    ({"enable_defense": True, "defense_type": "krum", "defense_plane": "compiled"}, "item 10:"),
    ({"enable_dp": True, "dp_type": "cdp", "dp_plane": "compiled"}, "item 10:"),
    ({"secagg_plane": "compiled"}, "item 10:"),
    ({"agg_plane": "compiled"}, "item 10:"),
    ({"server_state": "sharded"}, "item 10:"),
    ({"enable_defense": True, "defense_type": "foolsgold", "checkpoint_dir": "/nonexistent"},
     "item 9b:"),
])
def test_still_refused_knobs_raise(knobs, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue A, {item}"):
        _port_run(_config(knobs, "packed"))


def test_unknown_attack_type_has_no_hook():
    with pytest.raises(NotImplementedError, match="no XLA-backend hook"):
        _port_run(_config({"enable_attack": True, "attack_type": "sybil_flood"}, "packed"))
