"""The port's population subsystem against the JAX package's: registry,
the uniform, stratified and importance policies, ``_largest_remainder``,
``stacked_cohorts`` and the manager's simulator surface (``from_args``,
``select``, ``observe_round``, ``history``).

Both managers are built from the same knobs and sample counts and fed the
same ``observe_round`` calls (fixed seconds, so the stratified policy's
latency EMA is the same on both sides); every round's cohort must be the
same ids in the same order, bit for bit, and so must the registry's columns
and the ``cohort_stats`` records (the JAX records carry nothing more: its
``obs`` counters go to the metrics registry, not into the record).  Then the
two simulators through the entry points: the cohorts each drew and the
seconds it fed are replayed into a JAX manager, which must draw the same
cohorts; ``population_stacked`` gives the JAX package's stacked schedule.
All host numpy: no tolerance anywhere.
"""

import copy
import types

import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu.core.population import manager as jmanager
from fedml_tpu.core.population import policies as jpolicies
from fedml_tpu.core.population import stacked as jstacked
from fedml_tpu_torch.core.population import manager as tmanager
from fedml_tpu_torch.core.population import policies as tpolicies
from fedml_tpu_torch.core.population import stacked as tstacked


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, K, ROUNDS = 40, 7, 3
SECONDS = (0.37, 0.12, 0.81)  # each round's wall seconds, fed to both sides
KNOBS = {
    "uniform_blocklist": {"selection_policy": "uniform", "population_blocklist": [3, 17, 29]},
    "stratified": {"selection_policy": "stratified", "population_strata": 3},
    "stratified_blocklist": {"selection_policy": "stratified", "population_strata": 4,
                             "population_blocklist": [0, 1, 2, 38]},
    "importance_staleness": {"selection_policy": "importance", "importance_alpha": 0.7,
                             "importance_staleness": 0.5},
    "importance_paced": {"selection_policy": "importance", "pacing_overcommit": 1.5,
                         "pacing_quorum": 5},
}


def _managers(knobs):
    args = types.SimpleNamespace(**knobs)
    samples = np.random.RandomState(7).randint(0, 120, size=N).tolist()
    jm = jmanager.PopulationManager.from_args(args, np.arange(N), num_samples=samples,
                                              emit=lambda stats: None)
    tm = tmanager.PopulationManager.from_args(args, np.arange(N), num_samples=samples)
    return jm, tm


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_cohorts_registry_and_history_match_jax(name):
    jm, tm = _managers(KNOBS[name])
    assert type(tm.policy).__name__ == type(jm.policy).__name__
    for r in range(ROUNDS):
        jc, tc = jm.select(r, K), tm.select(r, K)
        assert tc.dtype == jc.dtype and tc.tolist() == jc.tolist(), (r, tc, jc)
        # the last client of the cohort misses the round once, to move the
        # failure column too
        reported = tc[:-1] if r == 1 else None
        js = jm.observe_round(r, jc, reported_ids=reported, seconds=SECONDS[r])
        ts = tm.observe_round(r, tc, reported_ids=reported, seconds=SECONDS[r])
        assert ts == js
    for col in ("num_samples", "invites", "reports", "failures", "last_seen_round",
                "ema_seconds", "_has_obs", "_blocked"):
        np.testing.assert_array_equal(getattr(tm.registry, col), getattr(jm.registry, col),
                                      err_msg=col)
    np.testing.assert_array_equal(tm.registry.speed_scores(), jm.registry.speed_scores())
    assert tm.history == jm.history and len(tm.history) == ROUNDS


def test_largest_remainder_matches_jax_with_overflow():
    cases = [([1, 5, 5], 9), ([2, 2, 2, 2], 7), ([1, 1, 10], 11), ([3, 0, 4], 5),
             ([7], 3), ([1, 9, 1, 1], 12)]
    for sizes, k in cases:
        got = tpolicies._largest_remainder(sizes, k)
        assert got == jpolicies._largest_remainder(sizes, k)
        assert sum(got) == k and all(q <= s for q, s in zip(got, sizes))


@pytest.mark.parametrize("weighted,blocked", [(False, None), (True, None), (True, [0, 5, 9]),
                                              (False, [11, 12])])
def test_stacked_cohorts_match_jax(weighted, blocked):
    w = np.random.RandomState(3).rand(N) * 10 if weighted else None
    if weighted:
        w[4] = 0.0  # a zero weight is never drawn
    got = tstacked.stacked_cohorts(N, K, 5, seed=11, weights=w, blocked=blocked)
    want = jstacked.stacked_cohorts(N, K, 5, seed=11, weights=w, blocked=blocked)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and got.shape == (5, K)


def test_refusals_match_jax():
    args = types.SimpleNamespace(selection_policy="nope")
    for mod in (tmanager, jmanager):
        with pytest.raises(ValueError, match="unknown selection_policy"):
            mod.PopulationManager.from_args(args, np.arange(4))
    with pytest.raises(NotImplementedError, match="item 9a"):
        tmanager.PopulationManager.from_args(types.SimpleNamespace(), np.arange(4),
                                             rng_style="pcg64")


SIM_CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "mnist", "partition_method": "hetero", "partition_alpha": 0.5,
                  "synthetic_train_size": 300},
    "model_args": {"model": "lr"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 12,
                   "client_num_per_round": 4, "comm_round": ROUNDS, "epochs": 1,
                   "batch_size": 32, "client_optimizer": "sgd", "learning_rate": 0.05},
    "validation_args": {"frequency_of_the_test": 5},
    "device_args": {"device_type": "cpu"},
}


def _port_run(backend, knobs):
    config = copy.deepcopy(SIM_CONFIG)
    config["train_args"].update(knobs)
    config["comm_args"] = {"backend": backend}
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, classes)
    runner = fedml_tpu_torch.FedMLRunner(args, fedml_tpu_torch.device.get_device(args),
                                         dataset, model)
    sim = runner.runner.sim if backend == "XLA" else runner.runner.fl_trainer
    fed = []  # (round, cohort, seconds) as the simulator fed its manager
    observe = sim.population.observe_round

    def observed(round_idx, ids, seconds=None, **kw):
        fed.append((round_idx, [int(c) for c in ids], seconds))
        return observe(round_idx, ids, seconds=seconds, **kw)

    sim.population.observe_round = observed
    runner.run()
    return args, dataset, sim, fed


@pytest.mark.parametrize("backend", ["sp", "XLA"])
@pytest.mark.parametrize("policy", ["stratified", "importance"])
def test_simulators_draw_jax_cohorts(backend, policy):
    knobs = {"selection_policy": policy, "population_strata": 2, "importance_staleness": 0.5}
    args, dataset, sim, fed = _port_run(backend, knobs)
    assert [r for r, _, _ in fed] == list(range(ROUNDS))
    assert all(s is not None and s > 0 for _, _, s in fed)
    local_num = dataset[4]
    samples = [int(local_num[i]) for i in range(int(args.client_num_in_total))]
    np.testing.assert_array_equal(sim.population.registry.num_samples, samples)
    jm = jmanager.PopulationManager.from_args(args, np.arange(len(samples)),
                                              num_samples=samples, emit=lambda stats: None)
    for r, cohort, seconds in fed:
        assert jm.select(r, int(args.client_num_per_round)).tolist() == cohort
        jm.observe_round(r, cohort, seconds=seconds)
    assert sim.population.history == jm.history


def test_round_simulator_draws_the_stacked_schedule():
    args, _, sim, fed = _port_run("XLA", {"population_stacked": True})
    want = jstacked.stacked_cohorts(int(args.client_num_in_total),
                                    int(args.client_num_per_round), ROUNDS, seed=0)
    assert [cohort for _, cohort, _ in fed] == want.tolist()
    assert sim.population.registry.invites.sum() == ROUNDS * int(args.client_num_per_round)
