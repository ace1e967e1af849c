"""The ``sp`` backend with FedAvg: the port's single-process simulator
(``simulation/sp/fedavg/fedavg_api.py`` over ``ml/trainer/cls_trainer.py``
and the ``ServerAggregator`` hooks) through ``init`` -> ``data.load`` ->
``models.hub.create`` -> ``FedMLRunner``, against the JAX package's
``FedAvgAPI`` on the same configs.

Both sides start from one tree of the JAX model's shapes filled from numpy
(``_cheap_jax_host``), transplanted.  Each client takes one
full batch per epoch (``batch_size`` at least the largest client's count,
so the bucket is one batch), where the engines' different shuffles cannot
matter.  Tolerances, global params after each round: ``lr`` on synthetic
mnist (8 clients, 4 a round, 3 rounds) atol 2e-5; the tiny TransformerLM on
shakespeare through the NWP trainer (2 rounds; the port's kernels run as
their plain versions, JAX attends through ``reference_attention``) 5e-5;
the deterministic trust runs (byzantine ``zero`` + krum, label flipping +
trimmed mean, model replacement + norm clipping; 8 of 8 clients, 2 rounds)
2e-5.  Eval dicts, which both round to 4 decimals, 2e-4.

The random rules (local DP, central DP, byzantine ``random``) draw from
torch generators, so they are held to replay (two runs, bitwise equal) and
DP to its noise scale: with lr 0 every client returns the global model, so
local DP moves the aggregate by sigma * sqrt(sum w_i^2) / sum w_i per
coordinate and central DP by sigma; the standard deviation over the 7,850
coordinates must lie within 5 % of it (its sampling error is about 0.8 %).
The privacy budget spent must equal the JAX accountant's.

Then the four ``examples/simulation/sp_fedavg_*_mnist_lr`` configs and the
nine of the ``sp`` zoo on the port, each building its class, every refusal
of the slice with its ROADMAP.md item, and the faults this slice repairs: the default configs and ``run_simulation``'s default
backend (the scoped TF32 pin: ``test_torch_fp32_pin.py``).
"""

import copy
import inspect
import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.models.transformer import TransformerConfig as JCfg, TransformerLM as JLM
from fedml_tpu_torch.models import convert
from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 3
LR_CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "mnist", "partition_method": "hetero", "partition_alpha": 0.5,
                  "synthetic_train_size": 400},
    "model_args": {"model": "lr"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 8,
                   "client_num_per_round": 4, "comm_round": ROUNDS, "epochs": 1,
                   "batch_size": 64, "client_optimizer": "sgd", "learning_rate": 0.05},
    "validation_args": {"frequency_of_the_test": 1},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "sp"},
}
NWP_CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "shakespeare", "partition_method": "homo",
                  "synthetic_train_size": 320},
    "model_args": {"model": "transformer"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 8,
                   "client_num_per_round": 4, "comm_round": 2, "epochs": 2,
                   "batch_size": 64, "client_optimizer": "sgd", "learning_rate": 0.1},
    "validation_args": {"frequency_of_the_test": 1},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "sp"},
}
CFG = dict(vocab_size=96, d_model=32, n_heads=2, n_layers=1, d_ff=64)
# the trust runs: every client in every round, so krum with 2 Byzantine
# clients sums 4 distances a score
TRUST = {"client_num_per_round": 8, "comm_round": 2}
DETERMINISTIC = {
    "byzantine_zero_krum": {"enable_attack": True, "attack_type": "byzantine",
                            "attack_mode": "zero", "byzantine_client_num": 2,
                            "enable_defense": True, "defense_type": "krum"},
    "label_flipping_trimmed_mean": {"enable_attack": True, "attack_type": "label_flipping",
                                    "original_class": 1, "target_class": 7,
                                    "byzantine_client_num": 2, "enable_defense": True,
                                    "defense_type": "coordinate_wise_trimmed_mean",
                                    "beta": 0.2},
    "model_replacement_norm_clipping": {"enable_attack": True,
                                        "attack_type": "model_replacement",
                                        "attack_scale": 5.0, "byzantine_client_num": 2,
                                        "enable_defense": True,
                                        "defense_type": "norm_diff_clipping",
                                        "norm_bound": 0.5},
}
RANDOM = {
    "ldp": {"enable_dp": True, "dp_type": "ldp", "mechanism_type": "gaussian",
            "epsilon": 50.0},
    "cdp": {"enable_dp": True, "dp_type": "cdp", "mechanism_type": "laplace", "epsilon": 50.0},
    "byzantine_random_krum": {"enable_attack": True, "attack_type": "byzantine",
                              "attack_mode": "random", "byzantine_client_num": 2,
                              "enable_defense": True, "defense_type": "krum"},
}
# the examples/simulation/sp_* configs that run on the port, and the class each builds
EXAMPLES = {"sp_fedavg_mnist_lr": "FedAvgAPI", "sp_fedavg_robust_mnist_lr": "FedAvgAPI",
            "sp_fedavg_cdp_mnist_lr": "FedAvgAPI", "sp_fedavg_ldp_mnist_lr": "FedAvgAPI",
            "sp_fedopt_mnist_lr": "FedOptAPI", "sp_fedprox_mnist_lr": "FedProxAPI",
            "sp_fednova_mnist_lr": "FedNovaAPI", "sp_fedsgd_mnist_lr": "FedSGDAPI",
            "sp_scaffold_mnist_lr": "ScaffoldAPI", "sp_feddyn_mnist_lr": "FedDynAPI",
            "sp_hierarchical_fl_mnist_lr": "HierarchicalFLAPI",
            "sp_decentralized_mnist_lr": "DecentralizedFLAPI",
            "sp_turbo_aggregate_mnist_lr": "TurboAggregateAPI"}
# the sp zoo, ported in slice 12: each optimizer the class create_sp_algorithm builds
ZOO_CLASSES = {"FedOpt": "FedOptAPI", "FedProx": "FedProxAPI", "FedNova": "FedNovaAPI",
               "SCAFFOLD": "ScaffoldAPI", "FedDyn": "FedDynAPI", "FedSGD": "FedSGDAPI",
               "Async_FedAvg": "AsyncFedAvgAPI", "HierarchicalFL": "HierarchicalFLAPI",
               "decentralized_fl": "DecentralizedFLAPI", "turbo_aggregate": "TurboAggregateAPI",
               "SpreadGNN": "SpreadGNNAPI"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread, so the suite's parallel workers do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.fixture(autouse=True)
def _clean_singletons():
    yield
    _reset_singletons()  # the singletons are process-global


def _config(base, **train):
    config = copy.deepcopy(base)
    config["train_args"].update(train)
    return config


def _record(api, to_numpy):
    """Wrap the API's cohort draw, server step and eval: the cohorts, the
    global params after each round and the eval dicts."""
    log = {"cohorts": [], "states": [], "evals": []}
    sample, update, test = api._client_sampling, api.server_update, api._test_global

    def sampling(round_idx):
        ids = sample(round_idx)
        log["cohorts"].append(list(ids))
        return ids

    def server_update(w_locals):
        out = update(w_locals)
        log["states"].append(to_numpy(out))
        return out

    def test_global(round_idx):
        out = test(round_idx)
        log["evals"].append(out)
        return out

    api._client_sampling, api.server_update, api._test_global = sampling, server_update, test_global
    return log


# the JAX trainer's and aggregator's jitted functions, shared by the runs of
# this module whose model and training knobs are the same (each JAX run
# would otherwise compile the same programs again)
_JAX_FNS = {}


def _jax_train_key(trainer, padded_n, batch_size):
    a = trainer.args
    return ("train", repr(trainer.module), padded_n, batch_size, trainer.loss_kind,
            trainer.grad_hook is None, int(getattr(a, "epochs", 1)),
            *(str(getattr(a, k, None)) for k in ("client_optimizer", "learning_rate",
                                                  "weight_decay", "momentum", "proximal_mu")))


def _jitted_weighted_mean(updates):
    """The JAX package's ``weighted_mean`` (sum_i (n_i / N) * tree_i, the
    weights host floats, the sum in client order) as one jitted program: the
    eager one dispatches an op a leaf and client, seconds a round for a deep
    model.  XLA may fuse a product into its add, a rounding apart."""
    total = float(sum(n for n, _ in updates))
    if total <= 0:
        raise ValueError("total sample count must be positive")
    return _JAX_FNS.setdefault("mean", jax.jit(lambda trees, ws: jax.tree_util.tree_map(
        lambda *xs: sum(x * w for x, w in zip(xs, ws)), *trees)))(
        [p for _, p in updates], [n / total for n, _ in updates])


# the JAX modules that call weighted_mean by their own name
_JAX_MEAN_USERS = ("fedml_tpu.core.aggregate", "fedml_tpu.simulation.sp.fedopt.fedopt_api",
                   "fedml_tpu.simulation.sp.fedsgd.fedsgd_api",
                   "fedml_tpu.simulation.sp.feddyn.feddyn_api",
                   "fedml_tpu.simulation.sp.hierarchical_fl.hier_api")


def _cheap_jax_host(mp):
    """The JAX sp path made cheap without changing what it computes: its init
    a tree of the model's shapes filled from numpy (``test_torch_packed.
    _filled_init``), its weighted mean jitted."""
    import importlib

    from fedml_tpu.simulation.sp.fedavg import fedavg_api as jfedavg_api
    from test_torch_packed import _filled_init

    mp.setattr(jfedavg_api, "init_variables", _filled_init)
    for name in _JAX_MEAN_USERS:
        mp.setattr(importlib.import_module(name), "weighted_mean", _jitted_weighted_mean)


def _jax_run(config, model=None):
    """The JAX FedAvgAPI's run: (log, final eval, init variables, API)."""
    from fedml_tpu.ml.aggregator import default_aggregator as jdefault_aggregator
    from fedml_tpu.ml.trainer.cls_trainer import ModelTrainerCLS as JTrainer

    fn_for, make_eval_fn = JTrainer._fn_for, jdefault_aggregator.make_eval_fn

    def shared_fn_for(trainer, padded_n, batch_size):
        key = _jax_train_key(trainer, padded_n, batch_size)
        if key not in _JAX_FNS:
            _JAX_FNS[key] = fn_for(trainer, padded_n, batch_size)
        return _JAX_FNS[key]

    def shared_eval_fn(module):
        return _JAX_FNS.setdefault(("eval", repr(module)), make_eval_fn(module))


    args = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(config)),
                          should_init_logs=False)
    dataset, classes = fedml_tpu.data.data_loader.load(args)
    model = model if model is not None else fedml_tpu.models.hub.create(args, classes)
    with pytest.MonkeyPatch.context() as mp:
        _cheap_jax_host(mp)
        mp.setattr(jdefault_aggregator, "make_eval_fn", shared_eval_fn)
        mp.setattr(JTrainer, "_fn_for", shared_fn_for)
        runner = fedml_tpu.FedMLRunner(args, fedml_tpu.device.get_device(args), dataset, model)
        api = runner.runner.fl_trainer
        init = jax.tree_util.tree_map(np.asarray, api.w_global)
        log = _record(api, lambda v: convert.state_from_flax(
            jax.tree_util.tree_map(np.asarray, v)))
        final = runner.run()
    return log, final, init, api


def _port_run(config, init=None, model=None):
    """The port's FedAvgAPI's run, from ``init`` (flax variables) when given:
    (log, final eval, API)."""
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
    log = _record(api, lambda v: {k: t.detach().cpu().numpy().copy() for k, t in v.items()})
    final = runner.run()
    return log, final, api


def _assert_states_close(got, want, atol, what):
    assert len(got) == len(want) and got
    for r, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol,
                                       err_msg=f"{what} round {r} {k}")


def _assert_evals_close(got, want):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert g["round"] == w["round"]
        for key in ("test_acc", "test_loss"):
            assert abs(g[key] - w[key]) <= 2e-4, (key, g, w)


@pytest.fixture(scope="module")
def lr_runs():
    jlog, jfinal, init, _ = _jax_run(LR_CONFIG)
    _reset_singletons()
    tlog, tfinal, api = _port_run(LR_CONFIG, init)
    _reset_singletons()
    return jlog, jfinal, tlog, tfinal, api


@pytest.fixture(scope="module")
def nwp_runs():
    jlog, jfinal, init, _ = _jax_run(NWP_CONFIG, JLM(JCfg(**CFG)))
    _reset_singletons()
    tlog, tfinal, api = _port_run(NWP_CONFIG, init,
                                  TransformerLM(TransformerConfig(**CFG), device="meta"))
    _reset_singletons()
    return jlog, jfinal, tlog, tfinal, api


# -- (a), (b): FedAvg parity ------------------------------------------------


def test_lr_cohorts_are_identical(lr_runs):
    jlog, _, tlog, *_ = lr_runs
    assert len(tlog["cohorts"]) == ROUNDS and tlog["cohorts"] == jlog["cohorts"]
    assert any(len(set(c)) == 4 for c in tlog["cohorts"])


def test_lr_global_params_agree_after_each_round(lr_runs):
    jlog, _, tlog, *_ = lr_runs
    _assert_states_close(tlog["states"], jlog["states"], 2e-5, "lr")


def test_lr_eval_dicts_agree(lr_runs):
    jlog, jfinal, tlog, tfinal, _ = lr_runs
    _assert_evals_close(tlog["evals"], jlog["evals"])
    assert tfinal == tlog["evals"][-1] and len(tlog["evals"]) == ROUNDS


def test_lr_round_records(lr_runs):
    _, _, tlog, _, api = lr_runs
    assert len(api.round_times) == ROUNDS
    counts = api.train_data_local_num_dict
    # one bucket: every client's count fits one batch of 64
    assert max(counts.values()) <= 64 and list(api.trainer._train_fns) == [(64, 64)]
    assert api.samples_per_round == [sum(counts[c] for c in cohort)
                                     for cohort in tlog["cohorts"]]


def test_nwp_trainer_and_params_agree(nwp_runs):
    from fedml_tpu_torch.ml.trainer.nwp_trainer import ModelTrainerNWP

    jlog, _, tlog, _, api = nwp_runs
    assert type(api.trainer) is ModelTrainerNWP
    assert tlog["cohorts"] == jlog["cohorts"]
    _assert_states_close(tlog["states"], jlog["states"], 5e-5, "transformer")


def test_nwp_eval_dicts_agree(nwp_runs):
    jlog, _, tlog, tfinal, _ = nwp_runs
    _assert_evals_close(tlog["evals"], jlog["evals"])
    assert tfinal == tlog["evals"][-1]


# -- (c) the trust hooks on sp -------------------------------------------------


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_trust_runs_agree_with_jax(name):
    config = _config(LR_CONFIG, **TRUST, **DETERMINISTIC[name])
    jlog, _, init, _ = _jax_run(config)
    from fedml_tpu.core.security.fedml_attacker import FedMLAttacker as JA

    jbad = JA.get_instance().get_byzantine_idxs(8)
    _reset_singletons()
    tlog, _, api = _port_run(config, init)
    from fedml_tpu_torch.core.security.fedml_attacker import FedMLAttacker

    assert FedMLAttacker.get_instance().get_byzantine_idxs(8) == jbad and len(jbad) == 2
    _assert_states_close(tlog["states"], jlog["states"], 2e-5, name)
    _assert_evals_close(tlog["evals"], jlog["evals"])


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_trust_runs_replay_bitwise(name):
    config = _config(LR_CONFIG, **TRUST, **RANDOM[name])
    runs = []
    for _ in range(2):
        runs.append(_port_run(config)[0]["states"])
        _reset_singletons()
    assert len(runs[0]) == 2
    for a, b in zip(*runs):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), (name, k)


def _lr0_delta_std(knobs):
    config = _config(LR_CONFIG, **{**TRUST, **knobs, "learning_rate": 0.0, "comm_round": 1})
    init = {}

    def first_update(api):
        init.update({k: v.numpy().copy() for k, v in api.w_global.items()})

    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    runner = fedml_tpu_torch.FedMLRunner(args, fedml_tpu_torch.device.get_device(args),
                                         dataset, fedml_tpu_torch.models.hub.create(args, classes))
    api = runner.runner.fl_trainer
    first_update(api)
    runner.run()
    delta = np.concatenate([(api.w_global[k].numpy() - init[k]).ravel() for k in init])
    counts = np.asarray([api.train_data_local_num_dict[i] for i in range(8)], np.float64)
    return float(delta.std()), counts


@pytest.mark.parametrize("dp_type", ["ldp", "cdp"])
def test_dp_noise_scale_within_statistical_bound(dp_type):
    from fedml_tpu_torch.core.dp.mechanisms import Gaussian

    got, counts = _lr0_delta_std({"enable_dp": True, "dp_type": dp_type,
                                  "mechanism_type": "gaussian", "epsilon": 2.0,
                                  "delta": 1e-5, "sensitivity": 0.01})
    scale = Gaussian.compute_sigma(2.0, 1e-5, 0.01)
    if dp_type == "ldp":
        scale *= np.sqrt((counts ** 2).sum()) / counts.sum()
    assert abs(got / scale - 1.0) < 0.05, (got, scale)


@pytest.mark.parametrize("dp_type", ["ldp", "cdp"])
def test_dp_budget_spent_equals_jax(dp_type):
    from fedml_tpu.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy as JDP
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy

    # one mechanism for both: JAX compiles its draw once
    config = _config(LR_CONFIG, enable_dp=True, dp_type=dp_type, mechanism_type="gaussian",
                     epsilon=50.0)
    _jax_run(config)
    want = list(JDP.get_instance().accountant._spends)
    _reset_singletons()
    _port_run(config)
    got = list(FedMLDifferentialPrivacy.get_instance().accountant._spends)
    # local DP spends once a client and round, central DP once a round
    assert len(want) == ROUNDS * (4 if dp_type == "ldp" else 1)
    assert got == want


# -- (d) the example configs -------------------------------------------------


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_config_runs_on_the_port(name, tmp_path):
    with open(os.path.join(REPO, "examples", "simulation", name, "fedml_config.yaml")) as f:
        config = yaml.safe_load(f)
    config["device_args"] = {"device_type": "cpu"}
    config["tracking_args"]["log_file_dir"] = str(tmp_path)
    config["data_args"]["data_cache_dir"] = str(tmp_path / "fedml_data")  # absent: synthetic
    _, final, api = _port_run(config)
    assert type(api).__name__ == EXAMPLES[name]
    assert 0.0 <= final["test_acc"] <= 1.0 and np.isfinite(final["test_loss"])
    assert final["round"] == int(config["train_args"]["comm_round"]) - 1


# -- (e) refusals --------------------------------------------------------------


@pytest.mark.parametrize("optimizer,item", [
    ("FedOpt", "item 2"), ("FedProx", "item 2"), ("FedNova", "item 2"), ("SCAFFOLD", "item 2"),
    ("FedDyn", "item 2"), ("FedSGD", "item 2"), ("Async_FedAvg", "item 2"),
    ("HierarchicalFL", "item 2"), ("decentralized_fl", "item 2"), ("turbo_aggregate", "item 2"),
    ("FedGKT", "item 4"), ("FedGAN", "item 4"), ("FedNAS", "item 4"), ("FedSeg", "item 4"),
    ("split_nn", "item 4"), ("classical_vertical", "item 4"), ("SpreadGNN", "item 2"),
])
def test_other_sp_optimizers_raise_with_their_item(optimizer, item):
    """The members of item 2, SpreadGNN (ported with the graph family),
    FedSeg (with the vision family, on a segmentation dataset) and the
    structural members of item 4 (with their models) build their class;
    none raises any more."""
    from fedml_tpu_torch.simulation.sp import create_sp_algorithm

    args = fedml_tpu_torch.Arguments.from_dict(_config(LR_CONFIG, federated_optimizer=optimizer))
    structural = {"FedGKT": ("FedGKTAPI", "cifar10"), "FedGAN": ("FedGanAPI", "mnist"),
                  "FedNAS": ("FedNASAPI", "cifar10"), "split_nn": ("SplitNNAPI", "mnist"),
                  "classical_vertical": ("VerticalFLAPI", "synthetic")}
    if optimizer in structural:
        cls, args.dataset = structural[optimizer]
        args = fedml_tpu_torch.init(args, should_init_logs=False)
        dataset, classes = fedml_tpu_torch.data.load(args)
        api = create_sp_algorithm(optimizer, args, torch.device("cpu"), dataset,
                                  fedml_tpu_torch.models.hub.create(args, classes))
        assert type(api).__name__ == cls
        return
    if optimizer == "FedSeg":
        args.dataset, args.model, args.synthetic_train_size = "synthetic_seg", "unet", 64
        args = fedml_tpu_torch.init(args, should_init_logs=False)
        dataset, classes = fedml_tpu_torch.data.load(args)
        api = create_sp_algorithm(optimizer, args, torch.device("cpu"), dataset,
                                  fedml_tpu_torch.models.hub.create(args, classes))
        assert type(api).__name__ == "FedSegAPI" and type(api.net).__name__ == "UNet"
        return
    if item == "item 2":
        args = fedml_tpu_torch.init(args, should_init_logs=False)
        dataset, classes = fedml_tpu_torch.data.load(args)
        api = create_sp_algorithm(optimizer, args, torch.device("cpu"), dataset,
                                  fedml_tpu_torch.models.hub.create(args, classes))
        assert type(api).__name__ == ZOO_CLASSES[optimizer]
        return
    with pytest.raises(NotImplementedError,
                       match=f"'{optimizer}' is not ported .*ROADMAP.md queue A, {item}:"):
        create_sp_algorithm(optimizer, args, torch.device("cpu"), None, None)


@pytest.mark.parametrize("knobs,error,match", [
    ({"fl_mode": "async"}, NotImplementedError, "ROADMAP.md queue A, item 2:"),
    ({"checkpoint_dir": "ckpt"}, NotImplementedError, "ROADMAP.md queue A, item 9b:"),
    ({"obs_trace": True}, NotImplementedError, "ROADMAP.md queue A, item 9d:"),
    ({"enable_profiler": True}, NotImplementedError, "ROADMAP.md queue A, item 9d:"),
    ({"agg_plane": "compiled"}, NotImplementedError, "ROADMAP.md queue A, item 10:"),
    # the id of the case that named item 8 before item 8 was ported
    pytest.param({"enable_attack": True, "attack_type": "dlg"}, NotImplementedError,
                 "analysis attack, which runs on the round simulator \\(backend: XLA\\)",
                 id="knobs5-NotImplementedError-ROADMAP.md queue A, item 8:"),
    ({"frequency_of_the_test": 0}, ValueError, "frequency_of_the_test"),
])
def test_sp_refusals_name_their_item(knobs, error, match):
    """``fl_mode: async`` (item 2) is ported now: it runs FedBuff.  Every
    other knob still raises, naming its item."""
    config = _config(LR_CONFIG, **knobs)
    if knobs == {"fl_mode": "async"}:
        _, final, api = _port_run(config)
        assert type(api).__name__ == "FedBuffAPI" and final["round"] == ROUNDS - 1
        return
    if "frequency_of_the_test" in knobs:
        config["validation_args"]["frequency_of_the_test"] = 0
    with pytest.raises(error, match=match):
        _port_run(config)


@pytest.mark.parametrize("dataset", ["stackoverflow_lr", "squad_span", "synthetic_det",
                                     "synthetic_s2s", "ego_linkpred", "moleculenet_mtl",
                                     "nbaiot", "synthetic_seg", "freesolv"])
def test_unported_trainer_families_raise_with_item_4(dataset):
    """The FedNLP family's trainers (tag prediction, span extraction,
    seq2seq), the FedGraphNN family's (link prediction, multi-task,
    regression), the vision tasks' (detection, segmentation) and the
    autoencoder's are ported now: each builds its class."""
    from fedml_tpu_torch.ml.trainer.trainer_creator import create_model_trainer

    args = fedml_tpu_torch.Arguments.from_dict(_config(LR_CONFIG))
    args.dataset = dataset
    ported = {"stackoverflow_lr": "ModelTrainerTAGPred", "squad_span": "ModelTrainerSpan",
              "synthetic_s2s": "ModelTrainerS2S", "ego_linkpred": "ModelTrainerLinkPred",
              "moleculenet_mtl": "ModelTrainerMTL", "freesolv": "ModelTrainerReg",
              "synthetic_det": "ModelTrainerDET", "synthetic_seg": "ModelTrainerSeg",
              "nbaiot": "ModelTrainerAE"}
    trainer = create_model_trainer(torch.nn.Linear(2, 2), args)
    assert type(trainer).__name__ == ported[dataset]


def test_ported_trainer_families():
    from fedml_tpu_torch.ml.trainer.cls_trainer import ModelTrainerCLS
    from fedml_tpu_torch.ml.trainer.nwp_trainer import ModelTrainerNWP
    from fedml_tpu_torch.ml.trainer.trainer_creator import create_model_trainer

    model = torch.nn.Linear(2, 2)
    for dataset, cls in (("mnist", ModelTrainerCLS), ("cifar10", ModelTrainerCLS),
                         ("shakespeare", ModelTrainerNWP), ("onto_tagging", ModelTrainerNWP)):
        args = fedml_tpu_torch.Arguments.from_dict(_config(LR_CONFIG))
        args.dataset = dataset
        assert type(create_model_trainer(model, args)) is cls
    assert [ModelTrainerCLS.padded_size(n, 16) for n in (1, 16, 17, 64, 65)] == [
        16, 16, 32, 64, 128]


@pytest.mark.parametrize("optimizer", ["classical_vertical", "split_nn", "FedGKT", "FedGAN",
                                       "FedNAS", "turbo_aggregate", "HierarchicalFL"])
def test_structural_optimizers_on_xla_raise_with_item_5(optimizer):
    """Under ``backend: XLA`` the optimizers whose JAX twin is a program of
    its own build that program's port, as ``decentralized_fl`` and
    ``spreadgnn`` do (``tests/test_torch_graph_simulation.py``): ``fedgan``
    and ``fednas`` (``tests/test_torch_gan_nas_inmesh.py``), the three split
    rounds (``tests/test_torch_split_inmesh.py``), Turbo-Aggregate and
    hierarchical FL (``tests/test_torch_group_inmesh.py``).  Only the
    ``MPI_PROC`` backend still names item 5 (below)."""
    from fedml_tpu_torch.simulation.simulator import create_simulator

    config = _config(LR_CONFIG, federated_optimizer=optimizer)
    config["comm_args"]["backend"] = "XLA"
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, classes)
    inmesh = {"FedGAN": "GANInMeshAPI", "FedNAS": "NASInMeshAPI",
              "classical_vertical": "VFLInMeshAPI", "split_nn": "SplitNNInMeshAPI",
              "FedGKT": "GKTInMeshAPI", "turbo_aggregate": "TurboAggregateInMeshAPI",
              "HierarchicalFL": "HierarchicalInMeshAPI"}
    assert type(create_simulator(args, torch.device("cpu"), dataset, model).sim
                ).__name__ == inmesh[optimizer]


def test_mpi_proc_backend_raises_with_item_5():
    """Item 5's ``MPI_PROC`` is ported: ``create_simulator`` builds one rank
    (world 1, no sockets), as the JAX package's does."""
    from fedml_tpu_torch.simulation.mpi_proc import MPIProcessSimulator
    from fedml_tpu_torch.simulation.simulator import create_simulator

    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(_config(LR_CONFIG)),
                                should_init_logs=False)
    args.backend = "MPI_PROC"
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, classes)
    sim = create_simulator(args, torch.device("cpu"), dataset, model)
    assert isinstance(sim, MPIProcessSimulator) and (sim.rank, sim.world) == (0, 1)


# -- (f) the repaired faults ---------------------------------------------------


@pytest.mark.parametrize("backend", ["sp", "XLA"])
def test_default_configs_load_the_same_attributes(backend, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"])
    want = vars(fedml_tpu.load_arguments("simulation", backend))
    got = vars(fedml_tpu_torch.load_arguments("simulation", backend))
    for key in ("yaml_config_file", "yaml_paths"):
        assert "fedml_tpu_torch" in str(got.pop(key)) and "fedml_tpu" in str(want.pop(key))
    assert got == want
    assert got["backend"] == backend and got["device_type"] == "tpu"


def test_run_simulation_defaults_to_sp_in_both_packages():
    for pkg in (fedml_tpu, fedml_tpu_torch):
        assert inspect.signature(pkg.run_simulation).parameters["backend"].default == "sp"
