"""The structural ``sp`` members on the port against their JAX twins: split
NN, classical vertical FL, FedNAS, FedGKT and FedGAN, on the same data and
from the same initial weights (each JAX twin's flax init transplanted; the
GAN's latent draws replayed from the JAX key chain, the VFL weights and the
alphas copied as arrays).

* Split NN on mnist (3 clients: 20 rows, 5 tiled to a batch, none), 2
  rounds of the relay, ``split_hidden`` 32: both halves within 2e-5, the
  eval dicts equal.
* Vertical FL on ``synthetic`` (60 features over 7 parties, uneven slices),
  5 rounds of full-batch descent, and on the golden NUS-WIDE fixture
  (multi-hot labels): weights and bias within 2e-5, the eval dicts equal
  (the loss within its rounding).
* FedNAS on cifar10 (4 clients of 16, 2 a round, batch 8, 2 rounds): the
  weights (SGD with momentum over GroupNorm convolutions) within 5e-5, the
  alphas (adam) within 2 ``arch_learning_rate`` a step and their update
  within 1e-3 of JAX's (relative norm), the genotype.
* FedGKT on cifar10 (3 clients of 20, 5 and 11 rows, all every round, so
  round 1 runs the KD term; a width-8 edge net, ``gkt_server_width`` 16,
  ``gkt_server_blocks`` 1): every client's edge params and the server tower
  within 5e-5, the server's logits, the eval dicts.
* FedGAN on mnist (3 clients: 16, 16 and 5 rows tiled to a batch;
  ``gan_latent_dim`` 8, ``gan_local_steps`` 2, batch 8, 2 rounds): G and D
  (adam) within 2 lr a step and each net's update within 0.15 of JAX's
  (relative norm), the health scores within 1e-3.
* The refusals: every trust hook on each member when it is built;
  ``frequency_of_the_test: 0`` (a ``ValueError``; FedGAN reads no
  frequency, as in JAX, and runs); ``classical_vertical``, ``split_nn`` and
  ``fedgkt`` under ``backend: XLA`` build their in-mesh rounds
  (``tests/test_torch_split_inmesh.py``).  FedGKT keeps
  a ``GKTClientNet`` passed in and ignores any other model.
* The three ``sp`` example configs as they stand run on the port with
  finite values.
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
import test_torch_sp_simulator as _sp
import test_torch_sp_zoo_hooks as _hooks
from fedml_tpu_torch.models import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SGD_ATOL = 2e-5
GN_ATOL = 5e-5  # the GroupNorm nets


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


@pytest.fixture(autouse=True, scope="module")
def _quick_jax():
    """The JAX twins' one-off host work made cheap, their rounds untouched:
    each model's init is flax's tree (``jax.eval_shape``) filled from a
    seeded numpy stream, which the port's run is then given (flax's eager
    init compiles for seconds), and the eager ``weighted_mean`` and the
    models' eager ``apply`` outside the jitted steps are jitted."""
    import flax.linen as fnn

    from fedml_tpu.models import darts, gan, gkt
    from fedml_tpu.simulation.sp.fedgan import fedgan_api
    from fedml_tpu.simulation.sp.fednas import fednas_api
    from fedml_tpu.simulation.sp.split_nn import split_nn_api
    from test_torch_vision_models import _filled

    classes = (gan.MNISTGenerator, gan.MNISTDiscriminator, darts.DARTSNetwork,
               gkt.GKTClientNet, gkt.GKTServerNet, split_nn_api._Front, split_nn_api._Back)
    with pytest.MonkeyPatch.context() as mp:
        for cls in classes:
            mp.setattr(cls, "init", lambda self, key, *a, **k: _filled(jax.eval_shape(
                lambda *s: fnn.Module.init(self, jax.random.PRNGKey(0), *s, **k), *a)))
            mp.setattr(cls, "apply", jax.jit(fnn.Module.apply, static_argnums=0))
        plain = fedgan_api.weighted_mean
        mean = jax.jit(lambda ws, trees: plain(list(zip(ws, trees))), static_argnums=0)
        for module in (fedgan_api, fednas_api):
            mp.setattr(module, "weighted_mean", lambda updates: mean(
                tuple(n for n, _ in updates), [p for _, p in updates]))
        yield


def config(optimizer, dataset, clients, per_round, rounds, bs, lr, size, backend="sp", **train):
    return {
        "common_args": {"training_type": "simulation", "random_seed": 0},
        "data_args": {"dataset": dataset, "data_cache_dir": "", "partition_method": "homo",
                      "synthetic_train_size": size},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": optimizer, "client_num_in_total": clients,
                       "client_num_per_round": per_round, "comm_round": rounds, "epochs": 1,
                       "batch_size": bs, "client_optimizer": "sgd", "learning_rate": lr,
                       **train},
        "validation_args": {"frequency_of_the_test": 1},
        "device_args": {"device_type": "cpu"},
        "comm_args": {"backend": backend},
    }


def both_args(cfg):
    """(JAX args, port args) of one config, each through its package's init."""
    jargs = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(cfg)),
                           should_init_logs=False)
    targs = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(cfg)),
                                 should_init_logs=False)
    return jargs, targs


def resized(dataset, sizes):
    """The dataset with its clients cut to ``sizes`` rows each, taken in turn
    from the training split (the same tuple feeds both packages)."""
    (_, tn, (x, y), test, _, _, lt, classes) = dataset
    local_train, local_num, cursor = {}, {}, 0
    for i, n in enumerate(sizes):
        local_train[i] = (x[cursor:cursor + n], y[cursor:cursor + n])
        local_num[i] = n
        cursor += n
    return [sum(sizes), tn, (x, y), test, local_num, local_train, lt, classes]


def load(cfg, sizes=None):
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(cfg)),
                                should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    return resized(dataset, sizes) if sizes else dataset


def state(tree):
    """A flax tree as {torch name: numpy array}."""
    return convert.state_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def max_diff(port_vars, flax_tree) -> float:
    want = state(flax_tree)
    assert sorted(port_vars) == sorted(want)
    return max(float(np.abs(port_vars[k].detach().cpu().numpy() - want[k]).max())
               for k in want)


def _float64(tree):
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)).astype(np.float64)
            for k, v in tree.items()}


def update_rel_err(port_final, ref_final, init) -> float:
    """||port - ref|| / ||ref - init|| over a whole tree ({name: array}):
    the gap between the two runs' updates relative to the reference's
    update.  Adam's sign flips near zero part single leaves by up to 2 lr a
    step and move this little; a step of the wrong size, sign or weight
    moves it to the order of 1."""
    port, ref, init = _float64(port_final), _float64(ref_final), _float64(init)
    gap = sum(float(np.sum((port[k] - ref[k]) ** 2)) for k in init)
    update = sum(float(np.sum((ref[k] - init[k]) ** 2)) for k in init)
    return (gap / update) ** 0.5


def transplant(module, flax_tree):
    """The flax tree's values as ``module``'s variables (on the CPU)."""
    return convert.variables_from_flax(flax_tree, module, CPU)


# -- split NN ----------------------------------------------------------------------------


def test_split_nn_matches_jax():
    from fedml_tpu.simulation.sp.split_nn.split_nn_api import SplitNNAPI as JSplit
    from fedml_tpu_torch.ml.engine.train import load_variables
    from fedml_tpu_torch.simulation.sp.split_nn.split_nn_api import SplitNNAPI

    cfg = config("split_nn", "mnist", 3, 3, 2, 8, 0.1, 100, split_hidden=32)
    dataset = load(cfg, sizes=(20, 5, 0))
    jargs, targs = both_args(cfg)
    japi = JSplit(jargs, None, dataset)
    api = SplitNNAPI(targs, CPU, dataset)
    assert api.front.fc1.weight.shape == (32, 784)
    load_variables(api.front, transplant(api.front, japi.front_params))
    load_variables(api.back, transplant(api.back, japi.back_params))
    want, got = japi.train(), api.train()
    assert got == want
    assert max_diff(api.front_params, japi.front_params) <= SGD_ATOL
    assert max_diff(api.back_params, japi.back_params) <= SGD_ATOL
    assert len(api.round_losses) == 2 and all(np.isfinite(api.round_losses))


# -- vertical FL --------------------------------------------------------------------------


def _vfl_pair(cfg, dataset):
    from fedml_tpu.simulation.sp.classical_vertical_fl.vfl_api import VerticalFLAPI as JVFL
    from fedml_tpu_torch.simulation.sp.classical_vertical_fl.vfl_api import VerticalFLAPI

    jargs, targs = both_args(cfg)
    japi, api = JVFL(jargs, None, dataset), VerticalFLAPI(targs, CPU, dataset)
    assert [len(s) for s in api.feature_slices] == [len(s) for s in japi.feature_slices]
    api.w = [torch.from_numpy(np.array(w)) for w in japi.w]  # the JAX draw
    want, got = japi.train(), api.train()
    assert got["round"] == want["round"] and got["test_acc"] == want["test_acc"]
    assert abs(got["train_loss"] - want["train_loss"]) <= 1.0001e-4
    for w, jw in zip(api.w, japi.w):
        assert float(np.abs(w.numpy() - np.asarray(jw)).max()) <= SGD_ATOL
    assert float(np.abs(api.b.numpy() - np.asarray(japi.b)).max()) <= SGD_ATOL
    return api


def test_vertical_fl_matches_jax_on_synthetic():
    cfg = config("classical_vertical", "synthetic", 2, 2, 5, 16, 0.1, 200, vfl_party_num=7)
    api = _vfl_pair(cfg, load(cfg))
    assert [len(s) for s in api.feature_slices] == [9, 9, 9, 9, 8, 8, 8]


def test_vertical_fl_takes_the_argmax_of_multi_hot_labels():
    from fedml_tpu_torch.data import loaders

    xt, yt, xe, ye = loaders.load_nuswide(os.path.join(REPO, "tests/fixtures/golden/nuswide"))
    dataset = [len(yt), len(ye), (xt, yt), (xe, ye), {}, {}, {}, yt.shape[1]]
    cfg = config("classical_vertical", "nuswide", 2, 2, 3, 16, 0.5, 0, vfl_party_num=2)
    api = _vfl_pair(cfg, dataset)
    assert torch.equal(api.y_tr, torch.from_numpy(yt.argmax(axis=-1)))


# -- FedNAS --------------------------------------------------------------------------------

NAS = dict(clients=4, per_round=2, rounds=2, bs=8, lr=0.05, size=64)
# the alphas' update gap read 4.1e-5 (sp and in-mesh); an arch_learning_rate
# 1.2x too large reads 0.20
NAS_UPDATE_RTOL = 1e-3


def nas_config(backend="sp"):
    return config("FedNAS", "cifar10", NAS["clients"], NAS["per_round"], NAS["rounds"],
                  NAS["bs"], NAS["lr"], NAS["size"], backend, arch_learning_rate=0.003)


def nas_alpha_bound(cfg) -> float:
    """2 lr for each adam step a client takes over the run."""
    t = cfg["train_args"]
    steps = (NAS["size"] // NAS["clients"]) // NAS["bs"] * t["comm_round"]
    return 2 * t["arch_learning_rate"] * steps


def nas_alphas_close(api, japi, cfg, alphas0):
    """The alphas leaf by leaf within 2 ``arch_learning_rate`` a step of
    JAX's, and their update within NAS_UPDATE_RTOL of JAX's."""
    ref = np.asarray(japi.alphas)
    assert float(np.abs(api.alphas.numpy() - ref).max()) <= nas_alpha_bound(cfg)
    err = update_rel_err({"a": api.alphas}, {"a": ref}, {"a": alphas0})
    assert err <= NAS_UPDATE_RTOL


def test_fednas_matches_jax():
    from fedml_tpu.simulation.sp.fednas.fednas_api import FedNASAPI as JNAS
    from fedml_tpu_torch.simulation.sp.fednas.fednas_api import FedNASAPI

    cfg = nas_config()
    dataset = load(cfg)
    jargs, targs = both_args(cfg)
    japi, api = JNAS(jargs, None, dataset), FedNASAPI(targs, CPU, dataset)
    api.params = transplant(api.net, japi.params)
    api.alphas = torch.from_numpy(np.array(japi.alphas))
    alphas0 = api.alphas
    want, got = japi.train(), api.train()
    assert max_diff(api.params, japi.params) <= GN_ATOL
    nas_alphas_close(api, japi, cfg, alphas0)
    assert got["genotype"] == want["genotype"]
    assert [e["round"] for e in api.eval_history] == [0, 1]
    assert abs(got["test_acc"] - want["test_acc"]) <= 1.0 / 12  # one test image of 12


# -- FedGKT --------------------------------------------------------------------------------


def test_fedgkt_matches_jax():
    from fedml_tpu.models.gkt import GKTClientNet as JClient
    from fedml_tpu.simulation.sp.fedgkt.gkt_api import FedGKTAPI as JGKT
    from fedml_tpu_torch.ml.engine.train import load_variables
    from fedml_tpu_torch.models.gkt import GKTClientNet
    from fedml_tpu_torch.simulation.sp.fedgkt.gkt_api import FedGKTAPI

    cfg = config("FedGKT", "cifar10", 3, 3, 2, 8, 0.05, 200, gkt_server_width=16,
                 gkt_server_blocks=1, gkt_alpha=0.5, gkt_temperature=2.0)
    dataset = load(cfg, sizes=(20, 5, 11))
    jargs, targs = both_args(cfg)
    japi = JGKT(jargs, None, dataset, JClient(num_classes=10, width=8))
    api = FedGKTAPI(targs, CPU, dataset, GKTClientNet(10, width=8, device="meta"))
    api._proto_client_params = transplant(api.client_net, japi._proto_client_params)
    load_variables(api.server_net, transplant(api.server_net, japi.server_params))
    want, got = japi.train(), api.train()
    assert got == want
    assert sorted(api.client_params) == sorted(japi.client_params) == [0, 1, 2]
    for cid, p in api.client_params.items():
        assert max_diff(p, japi.client_params[cid]) <= GN_ATOL, cid
    assert max_diff(api.server_params, japi.server_params) <= GN_ATOL
    for cid, logits in api.server_logits.items():
        np.testing.assert_allclose(logits.numpy(), japi.server_logits[cid], atol=1e-4)
    assert [len(v) for v in api.server_logits.values()] == [16, 8, 8]


def test_fedgkt_keeps_its_edge_net_and_ignores_other_models():
    from fedml_tpu_torch.models.gkt import GKTClientNet
    from fedml_tpu_torch.simulation.sp import create_sp_algorithm

    cfg = config("FedGKT", "cifar10", 2, 2, 1, 8, 0.05, 40)
    dataset = load(cfg)
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(cfg), should_init_logs=False)
    net = GKTClientNet(10, width=8, device="meta")
    assert create_sp_algorithm("FedGKT", args, CPU, dataset, net).client_net is net
    cnn = fedml_tpu_torch.models.hub.create(args, 10)
    api = create_sp_algorithm("FedGKT", args, CPU, dataset, cnn)
    assert type(api.client_net) is GKTClientNet and api.client_net.width == 32
    assert api.server_net.blocks == 3 and api.server_net.Conv_0.in_channels == 32


# -- FedGAN ----------------------------------------------------------------------------------


class JaxSpLatents:
    """The JAX sp FedGAN's draws, replayed: ``split`` of the run key before
    each client and before each health draw, ``split(rng, 4)`` a step."""

    def __init__(self, seed, latent):
        self.rng = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
        self.latent = latent

    def _next(self):
        self.rng, sub = jax.random.split(self.rng)
        return sub

    def client(self, round_idx, slot, cid, steps, bs):
        rng, zs = self._next(), []
        for _ in range(steps):
            rng, k1, k2, _kb = jax.random.split(rng, 4)
            zs.append([jax.random.normal(k, (bs, self.latent)) for k in (k1, k2)])
        return torch.from_numpy(np.array(zs))

    def health(self, round_idx):
        return torch.from_numpy(np.array(jax.random.normal(self._next(), (64, self.latent))))


GAN_LR = 0.002
GAN_STEPS = 2
# the updates' gap relative to JAX's update (``update_rel_err``) read
# 0.0029-0.074 here (G the larger: adam's first steps are near lr * sign(g),
# and G's near-zero gradients flip with roundoff); a client weighted twice,
# a client dropped or adam's b1 0.6 read 0.20-0.55
GAN_UPDATE_RTOL = 0.15


def gan_config(backend="sp"):
    return config("FedGAN", "mnist", 3, 3, 2, 8, GAN_LR, 100, backend, gan_latent_dim=8,
                  gan_local_steps=GAN_STEPS)


def gan_bound(rounds) -> float:
    """2 lr for each adam step a client takes over the run."""
    return 2 * GAN_LR * GAN_STEPS * rounds


def gan_close(api, japi, rounds, init):
    """G and D leaf by leaf within 2 lr a step of JAX's, and each net's
    update within GAN_UPDATE_RTOL of JAX's (``update_rel_err`` from
    ``init``, {"G": ..., "D": ...})."""
    for name, port, ref in (("G", api.g_params, japi.g_params),
                            ("D", api.d_params, japi.d_params)):
        assert max_diff(port, ref) <= gan_bound(rounds), name
        err = update_rel_err(port, state(ref), init[name])
        assert err <= GAN_UPDATE_RTOL, name


def test_fedgan_matches_jax_on_its_draws():
    from fedml_tpu.simulation.sp.fedgan.fedgan_api import FedGanAPI as JGAN
    from fedml_tpu_torch.simulation.sp.fedgan.fedgan_api import FedGanAPI

    cfg = gan_config()
    dataset = load(cfg, sizes=(16, 16, 5))
    jargs, targs = both_args(cfg)
    japi = JGAN(jargs, None, dataset)
    api = FedGanAPI(targs, CPU, dataset, latents=JaxSpLatents(0, 8))
    api.g_params = transplant(api.G, japi.g_params)
    api.d_params = transplant(api.D, japi.d_params)
    init = {"G": api.g_params, "D": api.d_params}
    history = []
    log = japi.metrics.log
    japi.metrics.log = lambda m, step=None: (history.append(dict(m)), log(m, step))
    want, got = japi.train(), api.train()
    gan_close(api, japi, 2, init)
    assert [h["round"] for h in api.history] == [h["round"] for h in history] == [0, 1]
    for h, jh in zip(api.history, history):
        assert abs(h["d_fake_score"] - jh["d_fake_score"]) <= 1e-3
    assert got["round"] == want["round"] == 1


def test_fedgan_default_draws_replay_and_reads_no_frequency():
    """The port's own draws come from CPU generators: a second run gives the
    same pair bit for bit.  ``frequency_of_the_test: 0`` runs, as the JAX
    twin never reads it."""
    from fedml_tpu_torch.simulation.sp.fedgan.fedgan_api import FedGanAPI

    cfg = gan_config()
    cfg["train_args"]["comm_round"] = 1
    cfg["validation_args"]["frequency_of_the_test"] = 0
    dataset = load(cfg, sizes=(16, 16, 5))
    runs = []
    for _ in range(2):
        api = FedGanAPI(both_args(cfg)[1], CPU, dataset)
        out = api.train()
        assert 0.0 <= out["d_fake_score"] <= 1.0
        runs.append(api.g_params)
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])


# -- refusals ----------------------------------------------------------------------------

MEMBERS = {"split_nn": "SplitNNAPI", "classical_vertical": "VerticalFLAPI",
           "FedNAS": "FedNASAPI", "FedGKT": "FedGKTAPI", "FedGAN": "FedGanAPI"}
_DATA = {"split_nn": "mnist", "classical_vertical": "synthetic", "FedNAS": "cifar10",
         "FedGKT": "cifar10", "FedGAN": "mnist"}


def _build(member, backend="sp", freq=1, **knobs):
    from fedml_tpu_torch.simulation.simulator import create_simulator

    cfg = config(member, _DATA[member], 2, 2, 1, 8, 0.05, 40, backend, **knobs)
    cfg["validation_args"]["frequency_of_the_test"] = freq
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(cfg), should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    return create_simulator(args, CPU, dataset, fedml_tpu_torch.models.hub.create(args, classes))


@pytest.mark.parametrize("hook", sorted(_hooks.HOOK_KNOBS))
@pytest.mark.parametrize("member", sorted(MEMBERS))
def test_member_refuses_every_trust_hook(member, hook):
    with pytest.raises(NotImplementedError,
                       match=f"{MEMBERS[member]} does not run the .*{hook}"):
        _build(member, **_hooks.HOOK_KNOBS[hook])


@pytest.mark.parametrize("member", sorted(MEMBERS))
def test_frequency_zero(member):
    if member == "FedGAN":
        assert type(_build(member, freq=0).fl_trainer).__name__ == "FedGanAPI"
        return
    with pytest.raises(ValueError, match="frequency_of_the_test must be >= 1"):
        _build(member, freq=0)


@pytest.mark.parametrize("member", ["classical_vertical", "split_nn", "FedGKT"])
def test_split_members_on_xla_still_raise_item_5(member):
    """Item 5's split rounds are ported: ``backend: XLA`` builds the in-mesh
    twin of each member (``simulation/xla/split.py``)."""
    want = {"classical_vertical": "VFLInMeshAPI", "split_nn": "SplitNNInMeshAPI",
            "FedGKT": "GKTInMeshAPI"}
    assert type(_build(member, backend="XLA").sim).__name__ == want[member]


# -- the example configs ---------------------------------------------------------------------


def run_example(name):
    with open(os.path.join(REPO, "examples/simulation", name, "fedml_config.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["device_args"] = {"device_type": "cpu"}
    cfg.pop("tracking_args", None)
    cfg["data_args"]["data_cache_dir"] = ""  # synthetic
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(cfg), should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    runner = fedml_tpu_torch.FedMLRunner(args, fedml_tpu_torch.device.get_device(args), dataset,
                                         fedml_tpu_torch.models.hub.create(args, classes))
    final = runner.run()
    return final, getattr(runner.runner, "fl_trainer", None) or runner.runner.sim


def finite(tree) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in tree.values())


@pytest.mark.parametrize("name,cls", [("sp_fedgan_mnist_gan", "FedGanAPI"),
                                      ("sp_fednas_cifar10_darts", "FedNASAPI"),
                                      ("sp_fedgkt_cifar10", "FedGKTAPI")])
def test_example_config_runs_on_the_port(name, cls):
    final, api = run_example(name)
    assert type(api).__name__ == cls and final["round"] == 1
    if cls == "FedGanAPI":
        assert 0.0 <= final["d_fake_score"] <= 1.0
        assert api.latent == 64 and finite(api.g_params) and finite(api.d_params)
    elif cls == "FedNASAPI":
        assert len(final["genotype"]) == 4 and finite(api.params)
        assert bool(torch.isfinite(api.alphas).all())
    else:
        assert np.all(np.isfinite(api.round_losses)) and finite(api.server_params)
