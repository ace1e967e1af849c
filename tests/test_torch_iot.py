"""The IoT anomaly-detection path of the port against the JAX package: the
``recon`` data kind, the autoencoder and ``ModelTrainerAE``.

* ``make_iot_traffic`` and both ``recon`` splits of ``iot_anomaly`` and
  ``nbaiot`` (and their federated partition) bit for bit, with JAX's dtypes:
  the train targets are a copy of the inputs (fp32), the test flags int32.
* The autoencoder's forward and its MSE gradients within 1e-5 of flax's
  (fp32 products of a few dozen terms; the sums run in another order).
* ``ModelTrainerAE.test`` within 1e-5 of JAX's on the 1,600-row ``nbaiot``
  test split (an even count), and on eight rows whose errors put the two
  middle values 2 apart: ``jnp.median``'s mean of the two middle values
  sets the threshold at 13.90, where ``torch.median``'s lower value would
  set it at 12.90 and flag the row of error 13.4.
* FedAvg on ``sp`` with ``sp_fedavg_iot_autoencoder``'s knobs (adam) but one
  full batch a client, where the engines' different shuffles cannot matter:
  the global params after each of 2 rounds within 2e-5, the eval dicts
  (recall included) within 2e-4 (both round to 4 decimals); the padded and
  packed rounds within 5e-5 (the graph family's bar for the round
  simulator), the targets kept fp32.
* The example config as it stands runs on the port with finite values.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import fedml_tpu
import fedml_tpu_torch
import test_torch_graph_simulation as _graph
import test_torch_nlp_simulation as _nlp
import test_torch_sp_simulator as _sp
from fedml_tpu_torch.models import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
AE_ATOL = 1e-5
CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "iot_anomaly", "partition_method": "homo",
                  "synthetic_train_size": 512},
    "model_args": {"model": "autoencoder"},
    # sp_fedavg_iot_autoencoder's knobs, one full batch a client
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 4,
                   "client_num_per_round": 4, "comm_round": 2, "epochs": 1,
                   "batch_size": 128, "client_optimizer": "adam", "learning_rate": 0.01},
    "validation_args": {"frequency_of_the_test": 1},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "sp"},
}


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


def _args(config):
    """(JAX args, port args) of one config."""
    jargs = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(config)),
                           should_init_logs=False)
    targs = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)),
                                 should_init_logs=False)
    return jargs, targs


# -- data ----------------------------------------------------------------------------


@pytest.mark.parametrize("n,feat,seed,proto_seed,frac", [
    (64, 24, 0, None, 0.0), (64, 24, 3, 0, 0.1), (50, 115, 10_000, 0, 0.1), (7, 5, 1, 2, 0.5)])
def test_make_iot_traffic_is_bit_for_bit(n, feat, seed, proto_seed, frac):
    from fedml_tpu.data import synthetic as jsyn
    from fedml_tpu_torch.data import synthetic

    want = jsyn.make_iot_traffic(n, feat, seed=seed, proto_seed=proto_seed, anomaly_frac=frac)
    got = synthetic.make_iot_traffic(n, feat, seed=seed, proto_seed=proto_seed,
                                     anomaly_frac=frac)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    assert int(got[1].sum()) == (max(1, int(frac * n)) if frac else 0)


@pytest.mark.parametrize("dataset", ["iot_anomaly", "nbaiot"])
def test_recon_splits_are_bit_for_bit(dataset):
    config = copy.deepcopy(CONFIG)
    config["data_args"].update(dataset=dataset, synthetic_train_size=200,
                               partition_method="hetero")
    jargs, targs = _args(config)
    want = fedml_tpu.data.data_loader.load_centralized(jargs)
    got = fedml_tpu_torch.data.data_loader.load_centralized(targs)
    feat = 24 if dataset == "iot_anomaly" else 115
    assert got["x_train"].shape == (200, feat) and got["x_test"].shape == (40, feat)
    assert got["y_train"].dtype == np.float32 and got["y_test"].dtype == np.int32
    assert np.array_equal(got["y_train"], got["x_train"])
    assert got["y_train"] is not got["x_train"]
    assert int(got["y_test"].sum()) == 4  # anomaly_frac 0.1 of the test rows
    for key in ("x_train", "y_train", "x_test", "y_test"):
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    assert got["input_shape"] == want["input_shape"] and got["class_num"] == 2
    jds, _ = fedml_tpu.data.data_loader.load(jargs)
    tds, _ = fedml_tpu_torch.data.load(targs)
    assert tds[4] == jds[4]
    for i in tds[5]:
        assert np.array_equal(tds[5][i][0], jds[5][i][0])


# -- the model -------------------------------------------------------------------------


def _flax_ae(feat, x):
    """The flax autoencoder and a tree of its shapes filled from numpy
    (``test_torch_packed._filled``: flax's eager init dispatches an op a
    leaf)."""
    from fedml_tpu.models.autoencoder import AutoEncoder as JAE
    from test_torch_packed import _filled

    model = JAE(feat_dim=feat)
    return model, _filled(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x)))


def _port_ae(feat, variables):
    from fedml_tpu_torch.ml.engine.train import init_variables, load_variables
    from fedml_tpu_torch.models.autoencoder import AutoEncoder

    module = AutoEncoder(feat, device="meta")
    init_variables(module, CPU)
    load_variables(module, convert.variables_from_flax(variables, module, CPU))
    return module


def test_autoencoder_forward_and_gradients_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(16, 24).astype(np.float32)
    jmodel, variables = _flax_ae(24, x)
    module = _port_ae(24, variables)
    assert [n for n, _ in module.named_parameters()] == [
        f"{layer}.{leaf}" for layer in ("enc1", "enc2", "dec1", "dec2")
        for leaf in ("weight", "bias")]
    assert module.enc2.out_features == 8 and module.dec1.out_features == 32
    np.testing.assert_allclose(module(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x))),
                               rtol=0, atol=AE_ATOL)
    jgrads = jax.jit(jax.grad(lambda v: jnp.mean(jnp.square(jmodel.apply(v, x) - x))))(
        variables)
    loss = torch.mean(torch.square(module(torch.from_numpy(x)) - torch.from_numpy(x)))
    loss.backward()
    want = convert.state_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0, atol=AE_ATOL,
                                   err_msg=name)


# -- the trainer's eval ---------------------------------------------------------------


def _trainer_pair(config, variables):
    """JAX's and the port's ModelTrainerAE holding the same variables."""
    from fedml_tpu.ml.trainer.ae_trainer import ModelTrainerAE as JTrainer
    from fedml_tpu_torch.ml.trainer.trainer_creator import create_model_trainer

    jargs, targs = _args(config)
    jtrainer = JTrainer(fedml_tpu.models.hub.create(jargs, 2), jargs)
    jtrainer.set_model_params(variables)
    module = _port_ae(int(fedml_tpu_torch.data.data_loader.DATASET_SPECS[
        config["data_args"]["dataset"]]["shape"][0]), variables)
    trainer = create_model_trainer(module, targs)
    assert type(trainer).__name__ == "ModelTrainerAE" and trainer.loss_kind == "mse"
    trainer.set_model_params({n: p.detach().clone() for n, p in module.named_parameters()})
    return jtrainer, trainer, targs


def _evals_close(got, want):
    assert sorted(got) == sorted(want) == ["test_anomaly_recall", "test_correct",
                                           "test_loss", "test_total"]
    for key in want:
        assert abs(got[key] - want[key]) <= AE_ATOL * max(1.0, abs(want[key])), (key, got, want)


def test_ae_eval_matches_jax_on_the_test_split():
    config = copy.deepcopy(CONFIG)
    config["data_args"].update(dataset="nbaiot", synthetic_train_size=0)  # the spec's sizes
    data = fedml_tpu_torch.data.data_loader.load_centralized(_args(config)[1])
    x, flags = data["x_test"], data["y_test"]
    assert len(flags) == 1600  # an even count: the median is a mean of two
    _, variables = _flax_ae(115, x[:1])
    jtrainer, trainer, targs = _trainer_pair(config, variables)
    want = jtrainer.test((x, flags), None, targs)
    got = trainer.test((x, flags), CPU, targs)
    _evals_close(got, want)
    assert got["test_total"] == 1600 and 0.0 <= got["test_anomaly_recall"] <= 1.0


def test_ae_eval_takes_the_mean_of_the_two_middle_errors():
    """With every weight zero the reconstruction is 0 and a row's error is
    mean(x²): rows of sqrt(e) give errors e.  Sorted, the middle two are 4
    and 6: jnp.median takes 5, and the deviations' median is 2 (its own
    middle two equal), so the cut is 5 + 3 * 1.4826 * 2 = 13.90 and the row
    of 13.4 is not flagged; torch.median's 4 would cut at 12.90 and flag it."""
    from fedml_tpu_torch.ml.trainer.ae_trainer import median

    errors = np.array([1.0, 2.0, 3.0, 4.0, 6.0, 7.0, 8.0, 13.4], np.float32)
    x = np.sqrt(errors)[:, None] * np.ones((1, 24), np.float32)
    flags = np.array([0, 0, 0, 0, 0, 0, 0, 1], np.int32)
    _, variables = _flax_ae(24, x[:1])
    variables = jax.tree_util.tree_map(jnp.zeros_like, variables)
    jtrainer, trainer, targs = _trainer_pair(copy.deepcopy(CONFIG), variables)
    want = jtrainer.test((x, flags), None, targs)
    got = trainer.test((x, flags), CPU, targs)
    _evals_close(got, want)
    assert got["test_correct"] == 7.0 and got["test_anomaly_recall"] == 0.0
    err = torch.from_numpy(errors)
    assert float(median(err)) == 5.0 and float(torch.median(err)) == 4.0
    assert float(median(err[:7])) == float(torch.median(err[:7])) == 4.0  # odd: the middle


def test_ae_trainer_trains_on_its_inputs():
    """A train split whose y is the inputs, flags or None trains the same."""
    from fedml_tpu_torch.ml.engine.train import init_variables

    config = copy.deepcopy(CONFIG)
    config["train_args"].update(batch_size=16, client_optimizer="sgd", learning_rate=0.1)
    rng = np.random.RandomState(1)
    x = rng.randn(32, 24).astype(np.float32)
    _, variables = _flax_ae(24, x[:1])
    finals = []
    for y in (x.copy(), np.zeros(32, np.int32), None):
        _, trainer, targs = _trainer_pair(config, variables)
        trainer.train((x, y), CPU, targs)
        finals.append(trainer.get_model_params())
    assert any(not torch.equal(finals[0][k], init_variables(
        _port_ae(24, variables), CPU)[k]) for k in finals[0])
    for other in finals[1:]:
        assert all(torch.equal(finals[0][k], other[k]) for k in finals[0])


# -- the rounds ---------------------------------------------------------------------


def test_sp_fedavg_matches_jax():
    tlog, tapi = _graph._sp_parity(copy.deepcopy(CONFIG), 2e-5)
    assert len(tlog["states"]) == 2 and type(tapi.trainer).__name__ == "ModelTrainerAE"
    assert max(tapi.train_data_local_num_dict.values()) <= 128  # one full batch
    assert all("test_anomaly_recall" in e for e in tlog["evals"])


@pytest.mark.parametrize("pack", [False, True], ids=["padded", "packed"])
def test_xla_round_matches_jax(pack):
    # the padded round takes one full batch a client (its shuffles are the
    # engines' own); the packed round's are numpy's on both sides
    config = copy.deepcopy(CONFIG)
    config["comm_args"]["backend"] = "XLA"
    config["train_args"].update(xla_pack=pack, batch_size=16 if pack else 128)
    config["validation_args"]["frequency_of_the_test"] = 0
    jstates, tstates, tsim = _nlp._xla_runs(config)
    assert tsim.packed == pack and len(tstates) == len(jstates) == 2
    assert tsim.loss_kind == "mse" and tsim.y_all.dtype is torch.float32
    assert tsim.y_all.shape == (512, 24) and torch.equal(tsim.y_all, tsim.x_all)
    _sp._assert_states_close(tstates, jstates, 5e-5, f"iot pack={pack}")


def test_example_config_runs_on_the_port():
    with open(os.path.join(REPO, "examples/simulation/sp_fedavg_iot_autoencoder",
                           "fedml_config.yaml")) as f:
        config = yaml.safe_load(f)
    config["device_args"] = {"device_type": "cpu"}
    config.pop("tracking_args", None)
    config["data_args"]["data_cache_dir"] = ""  # synthetic
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, classes)
    runner = fedml_tpu_torch.FedMLRunner(args, fedml_tpu_torch.device.get_device(args), dataset,
                                         model)
    final = runner.run()
    assert type(model).__name__ == "AutoEncoder" and model.dec2.out_features == 24
    assert final["round"] == 1 and 0.0 <= final["test_anomaly_recall"] <= 1.0
    assert np.isfinite(final["test_loss"]) and 0.0 < final["test_acc"] <= 1.0
