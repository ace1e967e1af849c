"""The in-mesh split-computation rounds of the port (``backend: XLA``:
``VFLInMeshAPI``, ``SplitNNInMeshAPI``, ``GKTInMeshAPI``) against their JAX
twins built on a one-device mesh, on the same data, from the same initial
weights (flax's trees transplanted, VFL's weight matrix copied).  On eight
virtual devices split NN would run eight relay chains; on one it runs the
one chain the port runs.

* Vertical FL on ``synthetic`` (5 rounds) and on the golden NUS-WIDE fixture
  (multi-hot labels, 3 rounds): ``w`` and ``b`` within 2e-5 (SGD on fp32
  products, the sums in another order), the eval dicts equal but the loss,
  which both round to 4 decimals (within one step of the rounding).
* Split NN on mnist (4 clients of 20, 5, 0 and 11 rows, batch 8, so the
  small clients' padded batches have no real row), 2 rounds: both halves
  within 2e-5, the eval dicts as for VFL.
* FedGKT on cifar10 (4 clients of 20, 5, 11 and 9 rows, 3 a round, batch 8,
  a width-8 edge net and a tower of width 16 with 1 block, 2 rounds, so a
  client met twice runs the KD term): every client's edge params and the
  tower within 5e-5 (the GroupNorm nets' bar, ``test_torch_structural_sp``),
  each logit-table row within 1e-4, the eval dicts equal.  The clients
  smaller than ``padded_n`` take momentum-only steps on their batches with no
  real row, as JAX's do.  The round's slots are its sampled clients, each
  once: no slot is a padding duplicate.
* ``SimulatorXLA`` builds the three; each refuses every trust hook and
  ``frequency_of_the_test: 0`` (on which the JAX rounds divide by zero); the
  three ``xla_*`` example configs run as they stand.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_sp_zoo_hooks as _hooks
import test_torch_structural_sp as _st
from test_torch_structural_sp import CPU, GN_ATOL, SGD_ATOL, both_args, load, max_diff, transplant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_clean_singletons = _st._clean_singletons
_quick_jax = _st._quick_jax


def _mesh(axis):
    return Mesh(np.array(jax.devices()[:1]), (axis,))


def _evals_equal(got, want):
    assert sorted(got) == sorted(want)
    assert got["round"] == want["round"] and got["test_acc"] == want["test_acc"]
    if "train_loss" in want:
        assert abs(got["train_loss"] - want["train_loss"]) <= 1.0001e-4


# -- vertical FL --------------------------------------------------------------------------


def _vfl_pair(cfg, dataset):
    from fedml_tpu.simulation.xla.split import VFLInMeshAPI as JVFL
    from fedml_tpu_torch.simulation.xla.split import VFLInMeshAPI

    jargs, targs = both_args(cfg)
    japi = JVFL(jargs, None, dataset, mesh=_mesh("party"))
    api = VFLInMeshAPI(targs, CPU, dataset)
    assert tuple(api.w.shape) == tuple(japi.w.shape) and api.parties == japi.parties
    api.w = torch.from_numpy(np.array(japi.w))  # the JAX draw
    want, got = japi.train(), api.train()
    _evals_equal(got, want)
    assert float(np.abs(api.w.numpy() - np.asarray(japi.w)).max()) <= SGD_ATOL
    assert float(np.abs(api.b.numpy() - np.asarray(japi.b)).max()) <= SGD_ATOL
    return api


def test_vfl_matches_jax_on_synthetic():
    cfg = _st.config("classical_vertical", "synthetic", 2, 2, 5, 16, 0.1, 200, "XLA",
                     vfl_party_num=3)
    api = _vfl_pair(cfg, load(cfg))
    assert api.w.shape == (60, 10) and len(api.round_losses) == 5


def test_vfl_takes_the_argmax_of_multi_hot_labels():
    from fedml_tpu_torch.data import loaders

    xt, yt, xe, ye = loaders.load_nuswide(os.path.join(REPO, "tests/fixtures/golden/nuswide"))
    dataset = [len(yt), len(ye), (xt, yt), (xe, ye), {}, {}, {}, yt.shape[1]]
    cfg = _st.config("classical_vertical", "nuswide", 2, 2, 3, 16, 0.5, 0, "XLA")
    api = _vfl_pair(cfg, dataset)
    assert torch.equal(api.y_tr, torch.from_numpy(yt.argmax(axis=-1)))


# -- split NN ----------------------------------------------------------------------------


def test_split_nn_matches_jax():
    from fedml_tpu.simulation.xla.split import SplitNNInMeshAPI as JSplit
    from fedml_tpu_torch.ml.engine.train import load_variables
    from fedml_tpu_torch.simulation.xla.split import SplitNNInMeshAPI

    cfg = _st.config("split_nn", "mnist", 4, 4, 2, 8, 0.1, 100, "XLA", split_hidden=16)
    dataset = load(cfg, sizes=(20, 5, 0, 11))
    jargs, targs = both_args(cfg)
    japi = JSplit(jargs, None, dataset, mesh=_mesh("client"))
    api = SplitNNInMeshAPI(targs, CPU, dataset)
    assert api.padded_n == japi.padded_n == 24 and api.front.fc1.weight.shape == (16, 784)
    load_variables(api.front, transplant(api.front, japi.front_params))
    load_variables(api.back, transplant(api.back, japi.back_params))
    want, got = japi.train(), api.train()
    _evals_equal(got, want)
    assert max_diff(api.front_params, japi.front_params) <= SGD_ATOL
    assert max_diff(api.back_params, japi.back_params) <= SGD_ATOL
    assert len(api.round_losses) == 2 and all(np.isfinite(api.round_losses))


# -- FedGKT -------------------------------------------------------------------------------


def test_fedgkt_matches_jax_with_clients_of_unequal_size():
    from fedml_tpu.models.gkt import GKTClientNet as JClient
    from fedml_tpu.simulation.xla.split import GKTInMeshAPI as JGKT
    from fedml_tpu_torch.ml.engine.train import load_variables
    from fedml_tpu_torch.models.gkt import GKTClientNet
    from fedml_tpu_torch.simulation.xla.split import GKTInMeshAPI

    cfg = _st.config("FedGKT", "cifar10", 4, 3, 2, 8, 0.05, 200, "XLA", gkt_server_width=16,
                     gkt_server_blocks=1, gkt_alpha=0.5, gkt_temperature=2.0)
    dataset = load(cfg, sizes=(20, 5, 11, 9))
    jargs, targs = both_args(cfg)
    japi = JGKT(jargs, None, dataset, JClient(num_classes=10, width=8), mesh=_mesh("client"))
    api = GKTInMeshAPI(targs, CPU, dataset, GKTClientNet(10, width=8, device="meta"))
    assert api.padded_n == japi.padded_n == 24 and api.n_batches == 3
    proto = jax.tree_util.tree_map(lambda t: np.asarray(t[0]), japi.edge_table)
    api._proto_client_params = transplant(api.client_net, proto)
    load_variables(api.server_net, transplant(api.server_net, japi.server_params))
    slots = [api.round_slots(r) for r in range(2)]
    assert all(len(s) == len(set(s)) == 3 for s in slots)  # no padding duplicate
    assert set(slots[0]) & set(slots[1])  # a client met twice: the KD term runs
    history = []
    log = japi.metrics.log
    japi.metrics.log = lambda m, step=None: (history.append(dict(m)), log(m, step))
    want, got = japi.train(), api.train()
    _evals_equal(got, want)
    assert [h for h in history if "server_loss" not in h] == api.eval_history
    assert sorted(api.client_params) == sorted(set(slots[0]) | set(slots[1]))
    for cid in range(4):
        edge = jax.tree_util.tree_map(lambda t: t[cid], japi.edge_table)
        assert max_diff(api.client_params.get(cid, api._proto_client_params), edge) <= GN_ATOL
    assert max_diff(api.server_params, japi.server_params) <= GN_ATOL
    for cid, logits in api.server_logits.items():
        assert logits.shape == (24, 10)
        np.testing.assert_allclose(logits.numpy(), np.asarray(japi.logit_table[cid]), atol=1e-4)
    assert np.asarray(japi.has_kd).tolist() == [float(c in api.server_logits) for c in range(4)]
    losses = [h["server_loss"] for h in history if "server_loss" in h]
    np.testing.assert_allclose(api.round_losses, losses, atol=1e-4)


# -- dispatch, refusals, the example configs -------------------------------------------------

INMESH = {"classical_vertical": "VFLInMeshAPI", "split_nn": "SplitNNInMeshAPI",
          "FedGKT": "GKTInMeshAPI"}


@pytest.mark.parametrize("hook", sorted(_hooks.HOOK_KNOBS))
@pytest.mark.parametrize("member", sorted(INMESH))
def test_inmesh_member_refuses_every_trust_hook(member, hook):
    with pytest.raises(NotImplementedError,
                       match=f"{INMESH[member]} does not run the .*{hook}"):
        _st._build(member, backend="XLA", **_hooks.HOOK_KNOBS[hook])


@pytest.mark.parametrize("member", sorted(INMESH))
def test_inmesh_member_refuses_frequency_zero(member):
    with pytest.raises(ValueError, match="frequency_of_the_test must be >= 1"):
        _st._build(member, backend="XLA", freq=0)


@pytest.mark.parametrize("name,cls", [("xla_vfl_synthetic_lr", "VFLInMeshAPI"),
                                      ("xla_split_nn_mnist_mlp", "SplitNNInMeshAPI"),
                                      ("xla_fedgkt_cifar10_cnn", "GKTInMeshAPI")])
def test_example_config_runs_on_the_port(name, cls):
    final, api = _st.run_example(name)
    assert type(api).__name__ == cls
    assert final["round"] == int(api.args.comm_round) - 1 and 0.0 <= final["test_acc"] <= 1.0
    assert np.all(np.isfinite(api.round_losses))
    if cls == "SplitNNInMeshAPI":
        assert api.front.fc1.out_features == 128  # split_hidden
    if cls == "GKTInMeshAPI":
        assert api.client_net.width == 32 and api.server_net.blocks == 3
        assert api.server_net.Conv_1.out_channels == 64
