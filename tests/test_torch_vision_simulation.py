"""The vision tasks end to end: ``init`` -> ``data.load`` ->
``models.hub.create`` -> ``FedMLRunner`` on the port against the JAX
package on the same configs, from the same flax variables.

* FedSeg on ``sp`` (``examples/simulation/sp_fedseg_synthetic_unet``, 2
  rounds, 4 clients of 20 masks, 2 a round): the port's ``FedSegAPI``
  against the JAX one, the global model after each round within 2e-5 and
  the eval dicts (pixel accuracy and mIoU, rounded to 4 decimals) within
  2e-4.  Its own loop: full batches only (a trailing partial batch is
  dropped), SGD with momentum 0.9 a client, ``weighted_mean``.  It keeps a
  segmentation module passed in and refuses the trust hooks its JAX twin
  skips.
* ``sp`` FedAvg on ``synthetic_det`` / ``tiny_detector`` (the ``det`` loss,
  [B, 5] float labels; one full batch a client): every global model within
  2e-5, the eval dicts within 2e-4.
* The round simulator's padded and packed rounds on ``synthetic_seg``
  (FedSeg: FedAvg in the round, the per-pixel CE) and ``synthetic_det``
  against the JAX ``XLASimulator`` on a one-device mesh: the global model
  after each of 2 rounds within 5e-5.
* Both FedSeg example configs as they stand run on the port.
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
import test_torch_nlp_simulation as _nlp
import test_torch_sp_simulator as _sp
import test_torch_sp_zoo as _zoo
from fedml_tpu_torch.models import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP_FEDSEG = "examples/simulation/sp_fedseg_synthetic_unet/fedml_config.yaml"
XLA_FEDSEG = "examples/simulation/xla_fedseg_synthetic_unet/fedml_config.yaml"


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


def _example(path, tmp_path=None, **train):
    with open(os.path.join(REPO, path)) as f:
        config = yaml.safe_load(f)
    config["device_args"] = {"device_type": "cpu"}
    config.pop("tracking_args", None)
    if tmp_path is not None:
        config["tracking_args"] = {"log_file_dir": str(tmp_path)}
    config["data_args"]["data_cache_dir"] = ""  # synthetic
    config["train_args"].update(train)
    return config


def _fedseg_config(**train):
    config = _example(SP_FEDSEG, **{"comm_round": 2, **train})
    config["data_args"]["synthetic_train_size"] = 80  # 20 masks a client: 1 step, 4 dropped
    return config


def _quick_jax(mp):
    """The JAX side's one-off host work made cheap, its rounds untouched: the
    UNet's and the TinyDetector's init is flax's tree (``jax.eval_shape``)
    filled from a seeded numpy stream, which the port's run is then given
    (flax's init compiles for seconds), and the eval's IoU counts are jitted
    (eagerly, each op compiles once a shape)."""
    import flax.linen as fnn

    from fedml_tpu.models import detection as jdetection, unet as junet
    from test_torch_vision_models import _filled

    for cls in (junet.UNet, jdetection.TinyDetector):
        mp.setattr(cls, "init", lambda self, key, sample, **k: _filled(jax.eval_shape(
            lambda s: fnn.Module.init(self, jax.random.PRNGKey(0), s, **k), sample)))
    mp.setattr(junet, "iou_counts", jax.jit(junet.iou_counts, static_argnums=2))


def _fedseg_runs(config):
    """The JAX FedSegAPI's run and the port's from its init: (each one's
    global models after every round, its eval history, the port's API)."""
    from fedml_tpu.simulation.sp.fedseg import fedseg_api as jfedseg
    from fedml_tpu_torch.simulation.sp.fedseg import fedseg_api

    def recorder(module, states, to_numpy, jit=False):
        mean = plain = module.weighted_mean
        if jit:  # the JAX mean, one program rather than an op a leaf
            fn = jax.jit(lambda ws, trees: plain(list(zip(ws, trees))), static_argnums=0)
            mean = lambda updates: fn(tuple(n for n, _ in updates),  # noqa: E731
                                      [p for _, p in updates])

        def recorded(updates):
            out = mean(updates)
            states.append(to_numpy(out))
            return out

        return recorded

    jstates, tstates = [], []
    args = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(config)),
                          should_init_logs=False)
    dataset, classes = fedml_tpu.data.data_loader.load(args)
    with pytest.MonkeyPatch.context() as mp:
        _quick_jax(mp)
        mp.setattr(jfedseg, "weighted_mean", recorder(jfedseg, jstates, lambda v: (
            convert.state_from_flax(jax.tree_util.tree_map(np.asarray, v))), jit=True))
        runner = fedml_tpu.FedMLRunner(args, None, dataset,
                                       fedml_tpu.models.hub.create(args, classes))
        japi = runner.runner.fl_trainer
        init = jax.tree_util.tree_map(np.asarray, japi.params)
        jfinal = runner.run()
    targs = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)),
                                 should_init_logs=False)
    device = fedml_tpu_torch.device.get_device(targs)
    tdataset, classes = fedml_tpu_torch.data.load(targs)
    model = fedml_tpu_torch.models.hub.create(targs, classes)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fedseg_api, "weighted_mean", recorder(fedseg_api, tstates, lambda v: {
            k: t.numpy().copy() for k, t in v.items()}))
        trunner = fedml_tpu_torch.FedMLRunner(targs, device, tdataset, model)
        tapi = trunner.runner.fl_trainer
        tapi.w_global = convert.variables_from_flax(init, model, device)
        tfinal = trunner.run()
    assert tfinal == tapi.eval_history[-1] and jfinal == japi.eval_history[-1]
    return (jstates, japi.eval_history), (tstates, tapi.eval_history), tapi


# -- FedSeg on sp ----------------------------------------------------------------------


def test_sp_fedseg_matches_jax():
    (jstates, jevals), (tstates, tevals), tapi = _fedseg_runs(_fedseg_config())
    assert type(tapi).__name__ == "FedSegAPI" and len(tstates) == len(jstates) == 2
    _sp._assert_states_close(tstates, jstates, 2e-5, "fedseg")
    assert len(tevals) == len(jevals) == 2
    for got, want in zip(tevals, jevals):
        assert sorted(got) == sorted(want) == ["round", "test_acc", "test_miou"]
        assert got["round"] == want["round"]
        for key in ("test_acc", "test_miou"):
            assert abs(got[key] - want[key]) <= 2e-4, (key, got, want)
    assert len(tapi.round_times) == 2


def test_fedseg_drops_the_partial_batch_and_keeps_a_passed_module():
    from fedml_tpu_torch.models.unet import UNet

    config = _fedseg_config(batch_size=8, comm_round=1)  # 20 = 2 x 8 + 4 dropped
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    net = UNet(classes, width=8, device="meta")
    api = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, net).runner.fl_trainer
    assert api.net is net
    seen = []
    forward = net.forward
    net.forward = lambda x: (seen.append(x.shape[0]), forward(x))[1]
    api._local_train(0, epochs=1)
    assert seen == [8, 8]  # the 4 left over take no step


@pytest.mark.parametrize("knobs,hook", [
    ({"enable_attack": True, "attack_type": "byzantine", "attack_mode": "random",
      "byzantine_client_num": 1}, "model attack"),
    ({"enable_defense": True, "defense_type": "norm_diff_clipping", "norm_bound": 5.0},
     "defense"),
    ({"enable_dp": True, "dp_type": "ldp", "mechanism_type": "laplace", "epsilon": 1.0},
     "local DP"),
])
def test_fedseg_refuses_the_trust_hooks_its_jax_twin_skips(knobs, hook):
    config = _fedseg_config(comm_round=1, **knobs)
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    with pytest.raises(NotImplementedError, match=f"FedSegAPI does not run the .*{hook}"):
        fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset,
                                    fedml_tpu_torch.models.hub.create(args, classes))


# -- detection on sp ---------------------------------------------------------------------


def _det_config(**train):
    train = {"federated_optimizer": "FedAvg", "comm_round": 2, "batch_size": 32, **train}
    config = _example(SP_FEDSEG, **train)
    config["data_args"].update(dataset="synthetic_det", synthetic_train_size=128)
    config["model_args"]["model"] = "tiny_detector"
    return config


def test_sp_fedavg_detection_matches_jax():
    config = _det_config()
    with pytest.MonkeyPatch.context() as mp:
        _quick_jax(mp)
        jlog, _, init, _ = _zoo.jax_run(config)
    _sp._reset_singletons()
    tlog, tapi = _zoo.port_run(config, init)
    assert type(tapi.trainer).__name__ == "ModelTrainerDET" and tapi.trainer.loss_kind == "det"
    assert max(tapi.train_data_local_num_dict.values()) <= 32  # one full batch
    assert tlog["trained"] == jlog["trained"]
    _sp._assert_states_close(tlog["states"], jlog["states"], 2e-5, "synthetic_det")
    _sp._assert_evals_close(tlog["evals"], jlog["evals"])
    for got, want in zip(tlog["evals"], jlog["evals"]):
        assert sorted(got) == sorted(want) and "test_mean_iou" in got
        assert abs(got["test_mean_iou"] - want["test_mean_iou"]) <= 2e-4


# -- the round simulator -------------------------------------------------------------------


@pytest.mark.parametrize("pack", [False, True], ids=["padded", "packed"])
@pytest.mark.parametrize("dataset", ["synthetic_seg", "synthetic_det"])
def test_xla_round_matches_jax(dataset, pack):
    # the padded round takes one full batch a client (its shuffles are the
    # engines' own); the packed round's are numpy's on both sides
    if dataset == "synthetic_seg":
        # 4 clients of 8 masks: each JAX round compiles its program anew
        config = _example(XLA_FEDSEG, comm_round=2, client_num_per_round=4, xla_pack=pack,
                          batch_size=4 if pack else 8)
        config["data_args"]["synthetic_train_size"] = 32
    else:
        config = _det_config(xla_pack=pack, batch_size=8 if pack else 32)
        config["comm_args"]["backend"] = "XLA"
    config["validation_args"]["frequency_of_the_test"] = 0
    with pytest.MonkeyPatch.context() as mp:
        _quick_jax(mp)
        jstates, tstates, tsim = _nlp._xla_runs(config)
    assert tsim.packed == pack and len(tstates) == len(jstates) == 2
    if dataset == "synthetic_seg":
        assert type(tsim.algo).__name__ == "FedAvgInMesh" and tsim.loss_kind == "ce"
        assert tsim.y_all.shape == (32, 32, 32) and tsim.y_all.dtype is torch.int32
    else:
        assert tsim.loss_kind == "det"
        assert tsim.y_all.shape == (128, 5) and tsim.y_all.dtype is torch.float32
    _sp._assert_states_close(tstates, jstates, 5e-5, f"{dataset} pack={pack}")


# -- the example configs as they stand --------------------------------------------------


@pytest.mark.parametrize("path,cls", [(SP_FEDSEG, "FedSegAPI"), (XLA_FEDSEG, "XLASimulator")])
def test_example_config_runs_on_the_port(path, cls, tmp_path):
    config = _example(path, tmp_path)
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    runner = fedml_tpu_torch.FedMLRunner(args, fedml_tpu_torch.device.get_device(args), dataset,
                                         fedml_tpu_torch.models.hub.create(args, classes))
    final = runner.run()
    api = getattr(runner.runner, "fl_trainer", None) or runner.runner.sim
    assert type(api).__name__ == cls
    assert 0.0 <= final["test_acc"] <= 1.0 and 0.0 <= final["test_miou"] <= 1.0
    assert final["round"] == int(config["train_args"]["comm_round"]) - 1
