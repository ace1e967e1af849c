"""The vision model zoo, its losses and its evals on the port against their
JAX twins.

* Every new hub key at batch 2 (NHWC images [2, 32, 32, 3], [2, 28, 28, 1]
  for the ``cnn`` keys, [2, 80] tokens for the ``rnn`` keys, [2, 64] for
  ``mlp``), from one flax variables tree transplanted: the output and the
  gradient of every parameter (of mean(out²)) within a tolerance stated per
  model, relative to the largest |value| of each (the deep GroupNorm nets
  against the JAX function run in float64, see ``DEEP``); and
  ``FlatLayout``'s row
  order equal to ``ravel_pytree``'s.  The tree is flax's own structure
  (``jax.eval_shape`` of ``init``) filled from a seeded numpy stream, so
  norm scales and biases are not 1 and 0; flax's jitted init of the deeper
  nets costs 5-10 s each.  Each alias key builds its canonical key's model
  in both hubs.
* Training with dropout made deterministic on both sides (a monkeypatch
  here only: flax ``nn.Dropout`` and the port's ``Dropout`` return their
  input): one local-training run of ``cnn`` (2 steps) through both engines
  within 1e-5.  The port's own dropout is held to its replay and
  its rate; torch cannot draw ``jax.random``'s masks.
* The naive ports each of these models invites, patched in, miss the JAX
  output: a symmetric ``k // 2`` padding of a stride-2 SAME convolution
  (``tiny_detector``, ``mobilenet`` and ``efficientnet`` at k 3,
  ``mobilenet_v3`` at k 5), a transposed convolution without the spatial
  flip (``unet``), a flatten in NCHW order (``cnn``, ``cnn_web``,
  ``tiny_detector``) and an LSTM whose weights stack in the sorted flax
  names' order rather than i, f, g, o (the ``rnn`` keys).
* The ``det`` loss and the per-pixel CE ([B, H, W] labels, the [B] mask
  broadcast) within 1e-6; ``box_iou``, ``iou_counts`` and ``mean_iou``
  within 1e-5 (the counts exactly); ``ModelTrainerSeg``'s and
  ``ModelTrainerDET``'s ``test`` within 1e-5 (an argmax near a tie may go
  either way: its slack is counted), the server aggregator's through them.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu_torch.ml.engine.train import init_variables, load_variables
from fedml_tpu_torch.models import convert

# The deep GroupNorm nets are held to the JAX function in float64: flax takes a
# group's variance as E[x^2] - E[x]^2, which in fp32 loses digits where a
# group's |mean| >> its spread (MobileNetV1's 2x2 maps, 32 values a group, put
# JAX's own fp32 gradients 3.3e-2 off its float64 ones; the port's sit within
# 7e-6), and the roundoff compounds through 14-28 normalised convolutions.
DEEP = "14-28 GroupNorm convolutions: held to JAX in float64, 1e-4"
# hub key -> (dataset, output dim, the port's class, tolerance, why that tolerance)
MODELS = {
    "cnn": ("femnist", 62, "CNN_DropOut", 1e-5, "shallow"),
    "cnn_web": ("mnist", 10, "CNN_WEB", 1e-5, "shallow"),
    "vgg11": ("cifar10", 10, "VGG", 1e-5, "no norm: plain convolutions, roundoff only"),
    "vgg16": ("cifar10", 10, "VGG", 1e-5, "no norm: plain convolutions, roundoff only"),
    "mobilenet": ("cifar10", 10, "MobileNetV1", 1e-4, DEEP),
    "mobilenet_v3": ("cifar10", 10, "MobileNetV3Small", 1e-4, DEEP),
    "efficientnet": ("cifar10", 10, "EfficientNet", 1e-4, DEEP),
    "unet": ("synthetic_seg", 3, "UNet", 1e-5, "shallow"),
    "tiny_detector": ("synthetic_det", 6, "TinyDetector", 1e-5, "shallow"),
    "mlp": ("agnews", 4, "MLP", 1e-5, "shallow"),
    "rnn": ("shakespeare", 90, "RNN_OriginalFedAvg", 1e-5, "shallow"),
    "rnn_fedshakespeare": ("shakespeare", 90, "RNN_FedShakespeare", 1e-5, "shallow"),
    "rnn_stackoverflow": ("shakespeare", 90, "RNN_StackOverFlow", 1e-5, "shallow"),
}
ALIASES = {"cnn_dropout": "cnn", "mobilenet_v1": "mobilenet", "efficientnet_b0": "efficientnet",
           "deeplabv3": "unet", "deeplabv3_plus": "unet", "yolo_lite": "tiny_detector",
           "rnn_fedavg": "rnn", "rnn_originalfedavg": "rnn", "lstm": "rnn",
           "lstm_tagpred": "rnn", "rnn_nwp": "rnn_stackoverflow"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _input(key, batch=2, seed=0):
    dataset = MODELS[key][0]
    shape = tuple(fedml_tpu_torch.data.data_loader.DATASET_SPECS[dataset]["shape"])
    rng = np.random.RandomState(seed)
    if key.startswith("rnn"):
        return rng.randint(0, 90, (batch,) + shape).astype(np.int32)
    if key == "mlp":  # agnews rows are 64 wide
        return rng.randn(batch, 64).astype(np.float32)
    # zero-mean images: flax's GroupNorm variance E[x^2] - E[x]^2 loses digits
    # where |mean| >> spread (ROADMAP.md C, "GroupNorm's variance")
    return rng.randn(batch, *shape).astype(np.float32)


def _filled(shapes, seed=0):
    """A flax variables tree of ``shapes`` filled from a seeded numpy stream:
    kernels N(0, 1/fan_in), embeddings N(0, 1/dim), scales 1 + N(0, 0.01),
    biases N(0, 0.01)."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if leaf == "bias":
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        fan = int(np.prod(s.shape[:-1])) if leaf == "kernel" else s.shape[-1]
        return (rng.randn(*s.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _args(key):
    return types.SimpleNamespace(model=key, dataset=MODELS[ALIASES.get(key, key)][0])


_CACHE = {}


def _models(key):
    """(JAX module, flax variables, port module on the CPU, its variables,
    the input, JAX's output and gradients by torch name: in float64 for the
    deep nets, else in fp32), built once a module."""
    if key not in _CACHE:
        dataset, classes = MODELS[key][:2]
        jmodel = fedml_tpu.models.hub.create(_args(key), classes)
        tmodel = fedml_tpu_torch.models.hub.create(_args(key), classes)
        x = _input(key)
        jvars = _filled(jax.eval_shape(lambda s: jmodel.init(jax.random.PRNGKey(0), s,
                                                             train=False), x))

        def loss(v, x):
            out = jmodel.apply(v, x, train=False)
            return jnp.mean(out ** 2), out

        def run(v, x):
            (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v, x)
            return np.asarray(out), convert.state_from_flax(
                jax.tree_util.tree_map(np.asarray, grads))

        if MODELS[key][4] == DEEP:
            with jax.enable_x64(True):
                ref = run(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jvars),
                          x.astype(np.float64))
        else:
            ref = run(jvars, x)
        cpu = torch.device("cpu")
        init_variables(tmodel, cpu)
        tvars = convert.variables_from_flax(jvars, tmodel, cpu)
        _CACHE[key] = (jmodel, jvars, tmodel, tvars, x, ref)
    jmodel, jvars, tmodel, tvars, x, ref = _CACHE[key]
    load_variables(tmodel, tvars)  # a test may have trained the module
    return jmodel, jvars, tmodel, tvars, x, ref[0], ref[1]


def _rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _port_forward(tmodel, x):
    tmodel.eval()
    with torch.no_grad():
        return tmodel(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("key", sorted(MODELS))
def test_forward_and_gradients_match_jax(key):
    _, jvars, tmodel, tvars, x, jout, jgrads = _models(key)
    tol = MODELS[key][3]
    assert type(tmodel).__name__ == MODELS[key][2]
    tmodel.eval()
    for p in tmodel.parameters():
        p.grad = None
    out = tmodel(torch.from_numpy(x))
    (out ** 2).mean().backward()
    assert tuple(out.shape) == jout.shape
    assert _rel_err(out.detach().numpy(), jout) <= tol, key
    assert sorted(jgrads) == sorted(n for n, _ in tmodel.named_parameters())
    for name, p in tmodel.named_parameters():
        err = _rel_err(p.grad.numpy(), jgrads[name])
        assert err <= tol, (key, name, err)
    # the round's client rows: the ravel_pytree order, column for column
    layout = convert.FlatLayout.of(tvars)
    flat = layout.ravel(tvars).numpy()
    assert np.array_equal(flat, np.asarray(ravel_pytree(jvars["params"])[0]))
    back = layout.unravel(torch.from_numpy(flat), tvars)
    assert all(torch.equal(back[k], tvars[k]) for k in tvars)


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_alias_builds_its_canonical_model(alias):
    """An alias builds its canonical key's model in both hubs (flax modules
    compare as dataclasses; the port's by class and parameter shapes)."""
    canon = ALIASES[alias]
    classes = MODELS[canon][1]
    assert (fedml_tpu.models.hub.create(_args(alias), classes)
            == fedml_tpu.models.hub.create(_args(canon), classes))
    tmodel = fedml_tpu_torch.models.hub.create(_args(alias), classes)
    want = fedml_tpu_torch.models.hub.create(_args(canon), classes)
    assert type(tmodel).__name__ == MODELS[canon][2] == type(want).__name__
    assert ([(k, p.shape) for k, p in tmodel.named_parameters()]
            == [(k, p.shape) for k, p in want.named_parameters()])


# -- dropout ------------------------------------------------------------------------------


def _no_dropout(mp):
    """Dropout made the identity on both sides (this test module only)."""
    import flax.linen as fnn

    from fedml_tpu_torch.models import cnn

    mp.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
    mp.setattr(cnn.Dropout, "forward", lambda self, x: x)


@pytest.mark.parametrize("key", ["cnn"])
def test_local_training_matches_jax_with_dropout_off(key):
    from fedml_tpu.ml.engine import train as jtrain
    from fedml_tpu_torch.ml.engine import train

    jmodel, jvars, tmodel, tvars, *_ = _models(key)
    x = _input(key, batch=4, seed=1)
    y = np.random.RandomState(2).randint(0, MODELS[key][1], 4).astype(np.int32)
    args = types.SimpleNamespace(client_optimizer="sgd", learning_rate=0.1, epochs=2)
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp)
        # with dropout on, the train-mode forward differs from the eval one
        jfn = jax.jit(jtrain.build_local_train(jmodel, args, 4, 4))
        want = jfn(jvars, x, y, 4, jax.random.PRNGKey(0))
        got = train.build_local_train(tmodel, args, 4, 4)(
            tvars, torch.from_numpy(x), torch.from_numpy(y), 4, seed=(0, 0, 0))
    want_state = convert.state_from_flax(jax.tree_util.tree_map(np.asarray, want.variables))
    assert got.steps == 2.0
    for name, v in got.variables.items():
        assert _rel_err(v.numpy(), want_state[name]) <= 1e-5, name
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-5)


def test_port_dropout_replays_and_keeps_its_rate():
    from fedml_tpu_torch.ml.engine import train
    from fedml_tpu_torch.models.cnn import Dropout
    from fedml_tpu_torch.utils.rng import seeded_generator

    layer = Dropout(0.25).train()
    x = torch.ones(256, 256)
    layer.generator = seeded_generator((1, 2))
    a = layer(x)
    layer.generator = seeded_generator((1, 2))
    assert torch.equal(a, layer(x))  # replay
    kept = a != 0
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    frac = float(kept.float().mean())
    assert abs(frac - 0.75) < 4 * np.sqrt(0.75 * 0.25 / x.numel()), frac
    assert torch.equal(layer.eval()(x), x)
    # through the engine: a client run replays its masks; another seed draws others
    _, _, tmodel, tvars, *_ = _models("cnn")
    x, y = torch.from_numpy(_input("cnn", 4, 1)), torch.randint(0, 62, (4,))
    args = types.SimpleNamespace(client_optimizer="sgd", learning_rate=0.1, epochs=1)
    fn = train.build_local_train(tmodel, args, 4, 4)
    runs = [fn(tvars, x, y, 4, seed=s).variables for s in ((0, 0, 1), (0, 0, 1), (0, 0, 2))]
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    assert any(not torch.equal(runs[0][k], runs[2][k]) for k in runs[0])


# -- the naive ports fail ------------------------------------------------------------------


def _naive_same(mp):
    from fedml_tpu_torch.models import resnet

    # torch's padding=k//2 on both sides: the same output size, shifted
    mp.setattr(resnet, "_pad_same", lambda x, k, stride, value=0.0: (x, (k // 2, k // 2)))


def _naive_flip(mp):
    import torch.nn.functional as F

    from fedml_tpu_torch.models import unet

    mp.setattr(unet.ConvTranspose, "forward", lambda self, x: F.conv_transpose2d(
        x, self.weight, self.bias, stride=self.stride))


def _naive_flatten(mp):
    from fedml_tpu_torch.models import cnn, detection

    flat = lambda x: x.reshape(x.shape[0], -1)  # noqa: E731 -- NCHW rows
    mp.setattr(cnn, "flatten_nhwc", flat)
    mp.setattr(detection, "flatten_nhwc", flat)


def _naive_gates(mp):
    from fedml_tpu_torch.models import rnn

    mp.setattr(rnn, "GATES", tuple(sorted(rnn.GATES)))  # f, g, i, o: the flax key order


@pytest.mark.parametrize("case,keys", [
    ("SAME padding", ("tiny_detector", "mobilenet", "mobilenet_v3", "efficientnet")),
    ("ConvTranspose flip", ("unet",)),
    ("NHWC flatten", ("cnn", "cnn_web", "tiny_detector")),
    ("LSTM gate order", ("rnn", "rnn_stackoverflow")),
])
def test_naive_port_misses_jax(case, keys):
    patch = {"SAME padding": _naive_same, "ConvTranspose flip": _naive_flip,
             "NHWC flatten": _naive_flatten, "LSTM gate order": _naive_gates}[case]
    for key in keys:
        _, _, tmodel, _, x, jout, *_ = _models(key)
        assert _rel_err(_port_forward(tmodel, x), jout) <= MODELS[key][3]
        with pytest.MonkeyPatch.context() as mp:
            patch(mp)
            naive = _port_forward(tmodel, x)
        assert naive.shape == jout.shape
        assert _rel_err(naive, jout) > 1e-3, (case, key)


def test_conv_transpose_layer_matches_flax_on_an_asymmetric_input():
    import flax.linen as fnn

    from fedml_tpu_torch.models.unet import ConvTranspose

    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 5, 4).astype(np.float32)  # NHWC, H != W
    kernel = rng.randn(2, 2, 4, 3).astype(np.float32)  # [kh, kw, in, out]
    bias = rng.randn(3).astype(np.float32)
    want = fnn.ConvTranspose(3, (2, 2), strides=(2, 2)).apply(
        {"params": {"kernel": kernel, "bias": bias}}, x)
    layer = ConvTranspose(4, 3, 2)
    state = convert.params_state_from_flax({"ConvTranspose_0": {"kernel": kernel, "bias": bias}})
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(state["ConvTranspose_0.weight"]))
        layer.bias.copy_(torch.from_numpy(state["ConvTranspose_0.bias"]))
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 6, 10, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    with torch.no_grad():  # unflipped, torch's own convention: another result
        naive = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), layer.weight, layer.bias, stride=2)
    assert np.abs(naive.permute(0, 2, 3, 1).numpy() - np.asarray(want)).max() > 1e-2


# -- losses and evals ------------------------------------------------------------------------


@pytest.mark.parametrize("mask", ["mixed", "all_padding"])
@pytest.mark.parametrize("kind", ["det", "pixel_ce"])
def test_loss_matches_jax(kind, mask):
    from fedml_tpu.ml.engine import train as jtrain
    from fedml_tpu_torch.ml.engine import train

    rng = np.random.RandomState(3)
    B = 6
    if kind == "det":
        logits = (rng.randn(B, 6 + 4) * 2).astype(np.float32)
        labels = np.concatenate([rng.randint(0, 6, (B, 1)), rng.rand(B, 4) * 1.5], 1)
        labels = labels.astype(np.float32)  # some box errors past the smooth-L1 knee
        loss_key = "det"
    else:
        logits = (rng.randn(B, 5, 4, 3) * 3).astype(np.float32)
        labels = rng.randint(0, 3, (B, 5, 4)).astype(np.int32)
        loss_key = "ce"
    m = (np.array([1, 1, 0, 1, 0, 1], np.float32) if mask == "mixed"
         else np.zeros(B, np.float32))
    got_mean, (got_total, got_count) = train.LOSS_FNS[loss_key](
        torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(m))
    want_mean, (want_total, want_count) = jax.jit(jtrain.LOSS_FNS[loss_key])(logits, labels, m)
    for got, want in ((got_mean, want_mean), (got_total, want_total),
                      (got_count, want_count)):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    if kind == "pixel_ce" and mask == "mixed":
        assert got_count.item() == 4 * 5 * 4  # the [B] mask over every pixel


def test_box_iou_and_iou_counts_match_jax():
    from fedml_tpu.ml.trainer.det_trainer import box_iou as jbox_iou
    from fedml_tpu.models import unet as junet
    from fedml_tpu_torch.ml.trainer.det_trainer import box_iou
    from fedml_tpu_torch.models import unet

    rng = np.random.RandomState(4)
    a, b = rng.rand(16, 4).astype(np.float32), rng.rand(16, 4).astype(np.float32)
    a[3] = b[3] + 5.0  # disjoint: IoU 0
    np.testing.assert_allclose(box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jax.jit(jbox_iou)(a, b)), rtol=0, atol=1e-5)
    jcounts = jax.jit(junet.iou_counts, static_argnums=2)
    jmean = jax.jit(junet.mean_iou, static_argnums=2)
    logits = rng.randn(3, 6, 6, 4).astype(np.float32)
    for masks in (rng.randint(0, 4, (3, 6, 6)),
                  rng.randint(0, 2, (3, 6, 6))):  # classes 2, 3 only in the prediction
        masks = masks.astype(np.int32)
        ti, tu = unet.iou_counts(torch.from_numpy(logits), torch.from_numpy(masks), 4)
        ji, ju = jcounts(logits, masks, 4)
        assert np.array_equal(ti.numpy(), np.asarray(ji)) and np.array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_allclose(
            unet.mean_iou(torch.from_numpy(logits), torch.from_numpy(masks), 4).item(),
            float(jmean(logits, masks, 4)), rtol=0, atol=1e-5)
    # a class in neither is left out of the mean
    one = np.zeros((1, 2, 2, 3), np.float32)
    one[..., 0] = 1.0
    zeros = np.zeros((1, 2, 2), np.int32)
    assert unet.mean_iou(torch.from_numpy(one), torch.from_numpy(zeros), 3).item() == 1.0


@pytest.mark.parametrize("key,dataset,trainer", [
    ("unet", "synthetic_seg", "ModelTrainerSeg"),
    ("tiny_detector", "synthetic_det", "ModelTrainerDET"),
])
def test_task_eval_matches_jax(key, dataset, trainer):
    """The trainer's eval against JAX's; the server aggregator evaluates
    through the same trainer class, as in JAX (each JAX trainer compiles its
    own eval, so its aggregator is not run again here)."""
    from fedml_tpu.ml.trainer.trainer_creator import create_model_trainer as jcreate
    from fedml_tpu_torch.ml.aggregator.aggregator_creator import create_server_aggregator
    from fedml_tpu_torch.ml.trainer.trainer_creator import create_model_trainer

    jmodel, jvars, tmodel, tvars, *_ = _models(key)
    args = {"dataset": dataset, "model": key, "synthetic_train_size": 400, "random_seed": 0,
            "client_num_in_total": 1, "partition_method": "homo"}
    j, t = (types.SimpleNamespace(**args), types.SimpleNamespace(**args))
    ds, _ = fedml_tpu_torch.data.data_loader.load(copy.copy(t))
    test_data = ds[3]
    assert len(test_data[1]) == 80  # two eval batches of the seg trainer
    jtrainer, ttrainer = jcreate(jmodel, j), create_model_trainer(tmodel, t)
    assert type(ttrainer).__name__ == trainer == type(jtrainer).__name__
    jtrainer.set_model_params(jvars)
    ttrainer.set_model_params(tvars)
    slack = _argmax_slack(tmodel, test_data, key)
    want, got = jtrainer.test(test_data, None, j), ttrainer.test(test_data, None, t)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5 + slack.get(k, 0.0),
                                   err_msg=k)
    aggregator = create_server_aggregator(tmodel, t)
    assert type(aggregator._probe).__name__ == trainer
    aggregator.set_model_params(tvars)
    assert aggregator.test(test_data, None, t) == got


def _argmax_slack(tmodel, test_data, key):
    """What a near tie may move: pixels (or boxes) whose two largest class
    logits lie within 1e-5 of each other (relative to the largest |logit|)
    may take either class in fp32, each moving ``test_correct`` by 1 and an
    IoU by at most 2 / its union."""
    from fedml_tpu_torch.models.unet import iou_counts

    logits = torch.from_numpy(_port_forward(tmodel, test_data[0]))
    if key == "tiny_detector":
        logits = logits[:, :-4]
    top2 = logits.topk(2, dim=-1).values
    ties = int(((top2[..., 0] - top2[..., 1]) <= 1e-5 * logits.abs().max()).sum())
    slack = {"test_correct": float(ties)}
    if key == "unet":
        _, union = iou_counts(logits, torch.from_numpy(test_data[1]), logits.shape[-1])
        slack["test_miou"] = 2.0 * ties / float(union[union > 0].min())
    return slack
