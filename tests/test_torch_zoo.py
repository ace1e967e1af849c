"""The algorithm zoo through the simulator: FedProx, FedOpt, FedNova, SCAFFOLD,
FedDyn, AsyncFedAvg and FedBuff (``fl_mode: async``), each on the padded and
the packed round, the port through ``init`` -> ``data.load`` ->
``models.hub.create`` -> ``FedMLRunner`` against the JAX package's
``XLASimulator`` on a one-device mesh.

Setup: ``mnist`` (synthetic, 400 images, Dirichlet(0.5) over 8 clients of
30-62 images), the hub's default model ``lr``, 4 clients a round, 3 rounds,
SGD lr 0.05.  Both sides start from the JAX init, transplanted.  The padded
round takes one full batch per epoch (batch 64, above the largest client),
because the two engines shuffle differently by design; the packed round takes
batch 8 (4-8 steps a client), where the two stream the same batches bit for
bit.

After each round the port must hold, against the JAX run: the same cohort in
the same layout, exactly; for the async members the same staleness values,
exactly (AsyncFedAvg's rounds since the last participation, FedBuff's
flushes from the virtual arrival queue); and, within atol 2e-5 (fp32, sums
taken in other orders, SCAFFOLD's hook adding c - c_i as one term), the
global params, the server state (FedOpt's moments, SCAFFOLD's c, FedDyn's
h) and the whole client-state table (SCAFFOLD's c_i, FedDyn's h_i).  The
worst case measured over the 14 runs was 1.1e-6, FedOpt's params after
round 3 on the packed round (adam divides each roundoff of a small
pseudo-gradient by its own small root); every other run stays under 5e-7.

Unit tests: the four server optimizers, and sgd without momentum, against
optax over 5 steps of seeded pseudo-gradients; ``staleness_weights``
against the JAX package's for the three policies; the JAX package's
refusals (SCAFFOLD with momentum, ``fl_mode: async`` with FedNova); the
``lr`` model's logits.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.async_fl import staleness as jstaleness
from fedml_tpu.parallel.mesh import create_fl_mesh
from fedml_tpu.simulation.xla import algorithms as jalgorithms
from fedml_tpu.simulation.xla import fed_sim as jfed_sim
from fedml_tpu_torch.core.async_fl import staleness as tstaleness
from fedml_tpu_torch.models import convert
from fedml_tpu_torch.simulation.sp.fedopt.fedopt_api import make_server_optimizer
from fedml_tpu_torch.simulation.xla import algorithms as talgorithms
from test_torch_simulation import _place_replicated


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = 2e-5
ROUNDS = 3
CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "mnist", "partition_method": "hetero", "partition_alpha": 0.5,
                  "synthetic_train_size": 400},
    "model_args": {"model": "lr"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 8,
                   "client_num_per_round": 4, "comm_round": ROUNDS, "epochs": 1,
                   "client_optimizer": "sgd", "learning_rate": 0.05},
    "validation_args": {"frequency_of_the_test": 0},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "XLA"},
}
MEMBERS = {
    "fedprox": {"federated_optimizer": "FedProx", "proximal_mu": 0.1},
    "fedopt": {"federated_optimizer": "FedOpt", "server_optimizer": "adam", "server_lr": 0.05},
    "fednova": {"federated_optimizer": "FedNova"},
    "scaffold": {"federated_optimizer": "SCAFFOLD"},
    "feddyn": {"federated_optimizer": "FedDyn", "feddyn_alpha": 0.1},
    "async_fedavg": {"federated_optimizer": "Async_FedAvg"},
    # the buffer fills the cohort: the JAX packed round lays out exactly
    # client_num_per_round slots
    "fedbuff": {"fl_mode": "async", "async_buffer_size": 4, "async_max_staleness": 2,
                "async_staleness_policy": "polynomial"},
}
KINDS = {"padded": {"batch_size": 64}, "packed": {"batch_size": 8, "xla_pack": True}}


def _config(member, kind):
    config = copy.deepcopy(CONFIG)
    config["train_args"].update(MEMBERS[member], **KINDS[kind])
    return config


def _port_tree(tree, table=False):
    """A JAX params-shaped tree (``linear/kernel``, ``linear/bias``; with a
    leading client axis when ``table``) as the port's {name: array}."""
    kernel = np.asarray(tree["linear"]["kernel"])
    return {"linear.weight": kernel.transpose(0, 2, 1) if table else kernel.T,
            "linear.bias": np.asarray(tree["linear"]["bias"])}


def _jax_server_state(member, state):
    if member == "fedopt":
        adam = state[0]
        return {"count": int(adam.count), "mu": _port_tree(adam.mu), "nu": _port_tree(adam.nu)}
    if member in ("scaffold", "feddyn"):
        return _port_tree(state)
    return {}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy().copy() if torch.is_tensor(tree) else tree


def _port_server_state(member, state):
    return _numpy(state) if member in ("fedopt", "scaffold", "feddyn") else {}


def _record(sim, log, snapshot):
    """Record each round's layout, the async staleness the round read, and
    a snapshot of (params, server state, client state) after the round."""
    schedule, gather, round_end = sim._schedule, sim.algo.gather_client_extras, \
        sim.algo.host_round_end

    def scheduled(sampled):
        ids, real = schedule(sampled)
        log["layouts"].append(([int(c) for c in ids], [float(r) for r in real]))
        return ids, real

    def gathered(client_state, ids, real, round_idx):
        cex = gather(client_state, ids, real, round_idx)
        if isinstance(sim.algo, (jalgorithms.AsyncFedAvgInMesh, talgorithms.AsyncFedAvgInMesh)):
            log["staleness"].append(np.asarray(cex).tolist())
        return cex

    def ended(*a):
        log["states"].append(snapshot(sim))
        return round_end(*a)

    sim._schedule, sim.algo.gather_client_extras, sim.algo.host_round_end = \
        scheduled, gathered, ended
    if sim.async_mode:
        next_flush = sim._async_next_flush

        def flushed():
            ids, stal = next_flush()
            log["flushes"].append(([int(c) for c in ids], dict(stal)))
            return ids, stal

        sim._async_next_flush = flushed


def _run_pair(member, kind):
    config = _config(member, kind)
    jlog = {"layouts": [], "staleness": [], "flushes": [], "states": []}
    tlog = copy.deepcopy(jlog)

    jargs = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(config)),
                           should_init_logs=False)
    jdataset, classes = fedml_tpu.data.data_loader.load(jargs)
    jmodel = fedml_tpu.models.hub.create(jargs, classes)
    jsim = jfed_sim.XLASimulator(jargs, jdataset, jmodel,
                                 mesh=create_fl_mesh(devices=jax.devices()[:1]))
    _place_replicated(jsim)  # round 1 reuses round 0's compiled program
    _record(jsim, jlog, lambda s: (
        _port_tree(jax.tree_util.tree_map(np.asarray, s.variables)["params"]),
        _jax_server_state(member, s.server_state),
        None if s.client_state is None else _port_tree(s.client_state, table=True)))

    targs = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)),
                                 should_init_logs=False)
    device = fedml_tpu_torch.device.get_device(targs)
    tdataset, tclasses = fedml_tpu_torch.data.load(targs)
    tmodel = fedml_tpu_torch.models.hub.create(targs, tclasses)
    trun = fedml_tpu_torch.FedMLRunner(targs, device, tdataset, tmodel)
    tsim = trun.runner.sim
    tsim.variables = convert.variables_from_flax(
        jax.tree_util.tree_map(np.asarray, jsim.variables), tmodel, device)
    _record(tsim, tlog, lambda s: (_numpy(s.variables),
                                   _port_server_state(member, s.server_state),
                                   None if s.client_state is None else _numpy(s.client_state)))
    jsim.train()
    trun.run()
    return jsim, tsim, jlog, tlog


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(member, kind):
        if (member, kind) not in cache:
            cache[(member, kind)] = _run_pair(member, kind)
        return cache[(member, kind)]

    return get


def _assert_close(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_close(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (int, float)):
        assert got == want, what
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=what)


CASES = [(m, k) for m in MEMBERS for k in KINDS]


@pytest.mark.parametrize("member,kind", CASES)
def test_same_layouts_and_staleness(runs, member, kind):
    jsim, tsim, jlog, tlog = runs(member, kind)
    assert len(tlog["layouts"]) == ROUNDS
    assert tlog["layouts"] == jlog["layouts"]
    assert tlog["staleness"] == jlog["staleness"]
    if member == "async_fedavg":
        assert len(tlog["staleness"]) == ROUNDS and any(any(s) for s in tlog["staleness"])
    assert tlog["flushes"] == jlog["flushes"]
    if member == "fedbuff":
        assert len(tlog["flushes"]) == ROUNDS
        assert any(any(stal.values()) for _, stal in tlog["flushes"])
        assert tsim.async_flushes == [stal for _, stal in tlog["flushes"]]
        assert tsim._async_cohort == jsim._async_cohort
        assert tsim._async_dispatched == jsim._async_dispatched


@pytest.mark.parametrize("member,kind", CASES)
def test_params_and_states_agree_after_each_round(runs, member, kind):
    jsim, tsim, jlog, tlog = runs(member, kind)
    assert type(tsim.algo).__name__ == type(jsim.algo).__name__
    assert tsim.packed == (kind == "packed")
    assert len(tlog["states"]) == len(jlog["states"]) == ROUNDS
    for r, (tstate, jstate) in enumerate(zip(tlog["states"], jlog["states"])):
        for what, got, want in zip(("params", "server state", "client state"), tstate, jstate):
            if want is None:
                assert got is None, (r, what)
            else:
                _assert_close(got, want, f"round {r} {what}")
    assert all(np.isfinite(tsim.round_losses)) and len(tsim.round_losses) == ROUNDS


# -- unit tests --------------------------------------------------------------

SERVER_OPTS = [("sgd", 0.9), ("sgd", 0.0), ("adam", 0.9), ("yogi", 0.9), ("adagrad", 0.9)]


@pytest.mark.parametrize("name,momentum", SERVER_OPTS)
def test_server_optimizer_matches_optax(name, momentum):
    from fedml_tpu.simulation.sp.fedopt.fedopt_api import make_server_optimizer as jmake

    args = types.SimpleNamespace(server_optimizer=name, server_lr=0.05, server_momentum=momentum)
    rs = np.random.RandomState(3)
    shapes = {"a": (5, 3), "b": (7,)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jtx, ttx = jmake(args), make_server_optimizer(args)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for step in range(5):
        grads = {k: rs.randn(*s).astype(np.float32) * (step + 1) for k, s in shapes.items()}
        if step == 2:
            grads["b"][:3] = 0.0  # a zero gradient: adagrad's and yogi's edge cases
        jupd, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        tupd, tstate = ttx.update({k: torch.from_numpy(v) for k, v in grads.items()}, tstate, tp)
        for k in shapes:
            np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]), rtol=2e-6,
                                       atol=1e-7, err_msg=f"{name} step {step} {k}")
        jp = {k: jp[k] + jupd[k] for k in shapes}
        tp = {k: tp[k] + tupd[k] for k in shapes}
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)
               if np.asarray(x).ndim > 0]
    tleaves = [t.numpy() for v in tstate.values() if isinstance(v, dict) for t in v.values()]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(sorted(tleaves, key=lambda x: (x.shape, float(x.sum()))),
                    sorted(jleaves, key=lambda x: (x.shape, float(x.sum())))):
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("policy", ["constant", "polynomial", "hinge"])
def test_staleness_weights_match_jax(policy):
    s = np.array([0, 1, 2, 3, 4, 5, 7, 12], np.float32)
    want = np.asarray(jstaleness.staleness_weights(policy, s, alpha=0.7, hinge_b=2))
    got = tstaleness.staleness_weights(policy, s, alpha=0.7, hinge_b=2)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for v in s:
        assert tstaleness.staleness_weight(policy, v, 0.7, 2) == \
            jstaleness.staleness_weight(policy, v, 0.7, 2)


def test_jax_refusals_are_kept():
    args = fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(_config("scaffold", "padded")))
    args.momentum = 0.9
    with pytest.raises(NotImplementedError, match="momentum"):
        talgorithms.create_inmesh_algorithm(args)
    with pytest.raises(NotImplementedError, match="momentum"):
        jalgorithms.create_inmesh_algorithm(args)
    args = fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(_config("fednova", "padded")))
    args.fl_mode = "async"
    with pytest.raises(ValueError, match="fl_mode=async"):
        talgorithms.create_inmesh_algorithm(args)
    with pytest.raises(ValueError, match="fl_mode=async"):
        jalgorithms.create_inmesh_algorithm(args)


def test_lr_logits_match_jax():
    from fedml_tpu.models.linear import LogisticRegression as JLR
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.ml.engine.train import init_variables, load_variables

    x = np.random.RandomState(5).rand(6, 28, 28, 1).astype(np.float32)
    jmodel = JLR(output_dim=10)
    jvars = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]))
    module = hub.create(types.SimpleNamespace(model="lr", dataset="mnist"), 10)
    own = init_variables(module, torch.device("cpu"), seed=1)
    assert own["linear.weight"].shape == (10, 784) and not own["linear.bias"].any()
    # lecun-normal, as flax's Dense: std 1/sqrt(784)
    assert abs(float(own["linear.weight"].std()) - 784 ** -0.5) < 3e-3
    load_variables(module, convert.variables_from_flax(
        jax.tree_util.tree_map(np.asarray, jvars), module, torch.device("cpu")))
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(jvars, jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("member", ["scaffold", "feddyn"])
def test_client_tables_keep_the_params_layout(member):
    """On a ResNet-20 (``channels_last`` convolution weights, 1x1
    projections), the client table's rows, a round's gathered rows and the
    server state are laid out as the params are, which a fused foreach op
    needs; and the server state is the table's mean (the rows start at 0 and
    take the same deltas), to fp32 roundoff."""
    config = _config(member, "packed")
    config["data_args"].update(dataset="cifar10", synthetic_train_size=128)
    config["model_args"]["model"] = "resnet20"
    config["train_args"].update(client_num_in_total=4, client_num_per_round=2, comm_round=2,
                                batch_size=16)
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, classes)
    runner = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)
    runner.run()
    sim = runner.runner.sim
    cex = sim.algo.gather_client_extras(sim.client_state, np.array([3, 1]), np.ones(2), 2)
    params = dict(model.named_parameters())
    assert any(p.dim() == 4 and not p.is_contiguous() for p in params.values())
    for k, p in params.items():
        assert sim.client_state[k][0].stride() == p.stride(), k
        assert cex[k][1].stride() == p.stride(), k
        assert sim.server_state[k].stride() == p.stride(), k
        assert torch.equal(cex[k][1], sim.client_state[k][1])
        mean = sim.client_state[k].double().mean(0)
        scale = float(sim.client_state[k].abs().max())
        assert scale > 0 and float((sim.server_state[k].double() - mean).abs().max()) <= \
            1e-6 * scale, k
    assert all(np.isfinite(sim.round_losses))
