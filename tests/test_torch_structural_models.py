"""The structural members' models and the ``feature`` data kind on the port
against their JAX twins.

* ``MNISTGenerator`` (the hub's ``gan``, latent 100), ``MNISTDiscriminator``
  (a [B, 28, 28] input and a [B, 28, 28, 1] one), ``DARTSNetwork`` (the
  hub's ``darts``, width 16, the alphas passed at call time),
  ``GKTClientNet`` (``gkt_client``, width 32, features and logits) and
  ``GKTServerNet`` (``gkt_server``, width 64, 3 blocks) at batch 2, from one
  flax variables tree transplanted (flax's own structure, ``jax.eval_shape``
  of ``init``, filled from a seeded numpy stream): every output and the
  gradient of every parameter (and of the alphas) of mean(out²) within
  1e-5, relative to the largest |value| of each; ``FlatLayout``'s row order
  equal to ``ravel_pytree``'s.
* The naive ports each model invites, patched in, miss the JAX output: the
  generator's transposed convolutions without the spatial flip, DARTS's
  3x3 average pool without the padding in its divisor, a symmetric (1, 1)
  padding of the stride-2 SAME stems (DARTS, GKT).
* ``derive_architecture`` agrees with JAX's on the same alphas (random,
  ``zero`` the largest, ties); ``init_alphas`` draws 1e-3 N(0, 1) from its
  CPU generator, the same numbers on every device.
* The ``feature`` kind (``synthetic``, ``synthetic_1_1``, ``uci``,
  ``lending_club``) bit for bit with JAX's, and a federated load of
  ``synthetic`` with its partitions; the hub keys and their aliases build
  their models, the autoencoder's too (sized by the spec, as in JAX).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.flatten_util import ravel_pytree

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu_torch.ml.engine.train import init_variables, load_variables
from fedml_tpu_torch.models import convert
from test_torch_vision_models import _filled, _rel_err

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_models():
    from fedml_tpu.models import darts, gan, gkt

    return {
        "gan": (gan.MNISTGenerator(), (2, 100)),
        "discriminator": (gan.MNISTDiscriminator(), (2, 28, 28)),
        "discriminator_nhwc": (gan.MNISTDiscriminator(), (2, 28, 28, 1)),
        "darts": (darts.DARTSNetwork(num_classes=10), (2, 32, 32, 3)),
        "gkt_client": (gkt.GKTClientNet(num_classes=10), (2, 32, 32, 3)),
        "gkt_server": (gkt.GKTServerNet(num_classes=10), (2, 16, 16, 32)),
    }


def _port_model(key):
    from fedml_tpu_torch.models import gan, hub

    if key.startswith("discriminator"):
        return gan.MNISTDiscriminator(device="meta")
    dataset = "mnist" if key == "gan" else "cifar10"
    return hub.create(types.SimpleNamespace(model=key, dataset=dataset), 10)


KEYS = ("gan", "discriminator", "discriminator_nhwc", "darts", "gkt_client", "gkt_server")
ALPHAS = (0.5 * np.random.RandomState(7).randn(4, 5)).astype(np.float32)
_CACHE = {}


def _sq(outs):
    return sum(jnp.mean(o ** 2) for o in outs) if isinstance(outs, tuple) else jnp.mean(outs ** 2)


def _models(key):
    """(flax variables, port module on the CPU with them, input, JAX's
    outputs, JAX's gradients by torch name (the alphas' under ``alphas``)),
    built once a key."""
    if key not in _CACHE:
        jmodel, shape = _jax_models()[key]
        x = np.random.RandomState(3).randn(*shape).astype(np.float32)  # zero mean
        extra = (ALPHAS,) if key == "darts" else ()
        jvars = _filled(jax.eval_shape(lambda s: jmodel.init(jax.random.PRNGKey(0), s, *extra),
                                       x))

        def loss(v, a, x):
            out = jmodel.apply(v, x, a) if key == "darts" else jmodel.apply(v, x)
            return _sq(out), out

        (_, out), (gv, ga) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            jvars, ALPHAS, x)
        grads = convert.state_from_flax(jax.tree_util.tree_map(np.asarray, gv))
        if key == "darts":
            grads["alphas"] = np.asarray(ga)
        out = tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else (np.asarray(out),)
        tmodel = _port_model(key)
        init_variables(tmodel, torch.device("cpu"))
        tvars = convert.variables_from_flax(jvars, tmodel, torch.device("cpu"))
        _CACHE[key] = (jvars, tmodel, tvars, x, out, grads)
    jvars, tmodel, tvars, x, out, grads = _CACHE[key]
    load_variables(tmodel, tvars)
    return jvars, tmodel, tvars, x, out, grads


def _port_run(key, tmodel, x):
    """The port's outputs (a tuple) and gradients by name."""
    for p in tmodel.parameters():
        p.grad = None
    alphas = torch.tensor(ALPHAS, requires_grad=True)
    xt = torch.from_numpy(x)
    out = tmodel(xt, alphas) if key == "darts" else tmodel(xt)
    out = out if isinstance(out, tuple) else (out,)
    sum((o ** 2).mean() for o in out).backward()
    grads = {n: p.grad.numpy() for n, p in tmodel.named_parameters()}
    if key == "darts":
        grads["alphas"] = alphas.grad.numpy()
    return tuple(o.detach().numpy() for o in out), grads


@pytest.mark.parametrize("key", KEYS)
def test_forward_and_gradients_match_jax(key):
    jvars, tmodel, tvars, x, jout, jgrads = _models(key)
    out, grads = _port_run(key, tmodel, x)
    assert [o.shape for o in out] == [o.shape for o in jout]
    for got, want in zip(out, jout):
        assert _rel_err(got, want) <= TOL, key
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        assert _rel_err(g, jgrads[name]) <= TOL, (key, name, _rel_err(g, jgrads[name]))
    layout = convert.FlatLayout.of(tvars)  # the ravel_pytree row order
    assert np.array_equal(layout.ravel(tvars).numpy(),
                          np.asarray(ravel_pytree(jvars["params"])[0]))


def _unflipped(mp):
    from fedml_tpu_torch.models import unet

    mp.setattr(unet.ConvTranspose, "forward", lambda self, x: F.conv_transpose2d(
        x, self.weight, self.bias, stride=self.stride, padding=self.padding))


def _pool_without_pads(mp):
    real = F.avg_pool2d
    mp.setattr(F, "avg_pool2d", lambda x, k, s=None, padding=0, count_include_pad=True:
               real(x, k, s, padding=padding, count_include_pad=False))


def _symmetric_stride2(mp):
    from fedml_tpu_torch.models import resnet

    real = resnet._pad_same
    mp.setattr(resnet, "_pad_same", lambda x, k, stride, value=0.0:
               (x, (k // 2, k // 2)) if stride == 2 else real(x, k, stride, value))


@pytest.mark.parametrize("naive,keys", [
    (_unflipped, ("gan",)), (_pool_without_pads, ("darts",)),
    (_symmetric_stride2, ("darts", "gkt_client")),
])
def test_naive_ports_miss_the_jax_output(naive, keys):
    for key in keys:
        _, tmodel, _, x, jout, _ = _models(key)
        with pytest.MonkeyPatch.context() as mp:
            naive(mp)
            out, _ = _port_run(key, tmodel, x)
        assert _rel_err(out[-1], jout[-1]) > 1e-3, (naive.__name__, key)


@pytest.mark.parametrize("case", ["random", "zero_largest", "ties"])
def test_derive_architecture_matches_jax(case):
    from fedml_tpu.models import darts as jdarts
    from fedml_tpu_torch.models import darts

    a = np.random.RandomState(5).randn(4, 5).astype(np.float32)
    if case == "zero_largest":
        a[:, darts.OPS.index("zero")] = 10.0
    if case == "ties":
        a = np.zeros((4, 5), np.float32)
        a[1, 2] = a[1, 3] = 1.0
    want = jdarts.derive_architecture(jnp.asarray(a))
    assert darts.derive_architecture(torch.from_numpy(a)) == want
    assert darts.derive_architecture(a) == want
    assert all(g["op"] != "zero" for g in want)


def test_init_alphas_draws_from_its_generator():
    from fedml_tpu_torch.models import darts
    from fedml_tpu_torch.utils.rng import ALPHAS_SALT, seeded_generator

    a = darts.init_alphas(3)
    assert a.shape == (darts.num_edges(), len(darts.OPS)) and a.dtype == torch.float32
    want = 1e-3 * torch.randn((4, 5), generator=seeded_generator((3, ALPHAS_SALT)))
    assert torch.equal(a, want) and torch.equal(darts.init_alphas(3, "cpu"), a)
    assert not torch.equal(darts.init_alphas(4), a)
    assert 1e-4 < float(a.abs().max()) < 5e-3


def _load_args(package, dataset, **data):
    base = {"common_args": {"training_type": "simulation", "random_seed": 0},
            "data_args": {"dataset": dataset, "data_cache_dir": "", "partition_method": "hetero",
                          "partition_alpha": 0.5, "synthetic_train_size": 200, **data},
            "train_args": {"client_num_in_total": 4, "client_num_per_round": 2,
                           "federated_optimizer": "FedAvg"}}
    return package.Arguments.from_dict(base)


@pytest.mark.parametrize("dataset", ["synthetic", "synthetic_1_1", "uci", "lending_club"])
def test_feature_kind_is_bit_identical_to_jax(dataset):
    want = fedml_tpu.data.data_loader.load_centralized(_load_args(fedml_tpu, dataset))
    got = fedml_tpu_torch.data.data_loader.load_centralized(_load_args(fedml_tpu_torch, dataset))
    assert got["class_num"] == want["class_num"] and got["input_shape"] == want["input_shape"]
    for key in ("x_train", "y_train", "x_test", "y_test"):
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key


def test_feature_kind_federated_load_matches_jax():
    want, wc = fedml_tpu.data.data_loader.load(_load_args(fedml_tpu, "synthetic"))
    got, gc = fedml_tpu_torch.data.data_loader.load(_load_args(fedml_tpu_torch, "synthetic"))
    assert gc == wc and got[:2] == want[:2] and got[4] == want[4]
    for i in range(4):
        for a, b in zip(got[5][i], want[5][i]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("alias,cls", [
    ("gan", "MNISTGenerator"), ("mnist_gan", "MNISTGenerator"),
    ("gkt_client", "GKTClientNet"), ("resnet8_gkt", "GKTClientNet"),
    ("gkt_server", "GKTServerNet"), ("resnet55_gkt", "GKTServerNet"),
    ("darts", "DARTSNetwork"), ("darts_network", "DARTSNetwork"),
])
def test_hub_keys_build_their_models(alias, cls):
    from fedml_tpu_torch.models import hub

    args = types.SimpleNamespace(model=alias, dataset="cifar10")
    model = hub.create(args, 10)
    assert type(model).__name__ == cls == type(fedml_tpu.models.hub.create(args, 10)).__name__
    assert all(p.is_meta for p in model.parameters())


@pytest.mark.parametrize("key", ["autoencoder", "ae", "anomaly_ae"])
def test_autoencoder_keys_still_raise_item_4d(key):
    """The autoencoder keys build it now (item 4d is done), sized by the
    dataset's spec as the JAX hub sizes it: 115 features on nbaiot, the
    default 24 where the spec names none."""
    from fedml_tpu_torch.models import hub

    for dataset, feat in (("nbaiot", 115), ("iot_anomaly", 24), ("unknown", 24)):
        args = types.SimpleNamespace(model=key, dataset=dataset)
        model = hub.create(args, 2)
        want = fedml_tpu.models.hub.create(args, 2)
        assert type(model).__name__ == type(want).__name__ == "AutoEncoder"
        assert model.enc1.in_features == model.dec2.out_features == want.feat_dim == feat
        assert all(p.is_meta for p in model.parameters())
