"""BatchNorm (``model_norm: bn``) on the port against flax's ``nn.BatchNorm``
and the JAX package's engines, rounds and ``sp`` members.

* **The layer** (``models/resnet.py``'s ``BatchNorm``) against flax
  ``nn.BatchNorm(momentum=0.9)`` on NHWC batches whose last rows repeat a
  row, as a padded client's do: two training forwards, the running mean and
  variance after each (the biased batch variance, momentum 0.9), an eval
  forward on the running averages, and the gradients of a masked loss in the
  input, the scale and the bias.  fp32: atol 1e-5 (they read about 1e-6).
  bf16 compute: the statistics and the running averages stay fp32 and are
  held at 1e-5; the output, rounded to bf16 once on each side, within one
  bf16 step, 2^-8 of max |y|.  torch's ``BatchNorm2d`` rules (the unbiased
  variance, ``momentum=0.9`` read as torch's) are planted and must miss
  1e-5.
* **Whole models:** ResNet-20-bn (32x32 images) and ``MobileNetV1(norm="bn",
  width=0.25)`` (16x16) against the flax function in float64, from
  one tree transplanted by ``convert.variables_from_flax``: a training
  forward's logits and its ``batch_stats``, and an eval forward (ResNet-20
  also every parameter's gradient), each within a bound of its leaf's
  largest entry (``MODEL_CASES``): the port's ResNet-20 in float64 at 1e-9,
  the hub's fp32 one at 1e-5 (logits, running averages) and 5e-2
  (gradients, see the conditioning below), the MobileNet in fp32 at 1e-4.
* **Layout:** ``FlatLayout``'s columns on a bn tree equal ``ravel_pytree``'s
  (every ``batch_stats`` leaf before the first parameter) bit for bit.
* **Freeze:** a client whose shuffle leaves one batch all padding ends as a
  client trained on its one real batch alone (1e-6): the padding step moved
  neither the parameters nor the running averages.
* **Runs** of ResNet-20-bn on cifar10 (synthetic, 40 images over 4
  Dirichlet clients of 8-11, 1 round) through ``init`` -> ``data.load`` ->
  ``models.hub.create`` -> ``FedMLRunner``, against the JAX package from one
  filled tree: the padded round (3 clients, one full batch of 16 each, padding
  rows included, where the engines' shuffles cannot matter), the packed round
  (3 clients, batch 4, the same numpy stream on both sides), and ``sp``
  FedAvg and FedOpt (adam) with one full batch per client, at bench.py's learning rate 0.001.  ``params`` and
  ``batch_stats`` after the round within 5e-5.  ``sp``'s eval on the running
  averages, which both packages round to 4 decimals: within 1e-4 + 1e-4 of
  the value.  After one round the averages are still mostly the filled
  ones, so the eval's activations run large (the loss reads about 4.2) and
  its loss moves by a relative 1e-4 under the parameters' roundoff.

Conditioning: BatchNorm's backward subtracts from each activation's
gradient its projections on the batch's mean and normalised input, and on
these images whole channels' gradients cancel to a few percent of their
parts.  The port in float64 equals the JAX function in float64, while fp32
gradients, the port's and JAX's alike, sit a few percent off the float64
ones on the worst leaf.  That roundoff, times the learning rate and the
steps, is what the rounds' 5e-5 holds: at lr 0.005 the packed round
(several steps a client) read 1.1e-4 on ``conv_init``.

The JAX side is made cheap without changing what it computes: its init is
a tree of the model's shapes (``jax.eval_shape``) filled from numpy
(``test_torch_packed._filled``), the two ``sp`` runs share their jitted
trainer and eval functions, and ``sp``'s weighted mean runs jitted
(``test_torch_sp_simulator._cheap_jax_host``).
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.models import mobilenet as jmobilenet, resnet as jresnet
from fedml_tpu_torch.ml.engine.train import (build_local_train, get_variables,
                                             load_variables, shuffle_generator)
from fedml_tpu_torch.models import convert, hub, mobilenet, resnet
from test_torch_packed import _filled
from test_torch_sp_simulator import _cheap_jax_host


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(atol=1e-5, rtol=1e-4)
CPU = torch.device("cpu")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _layer_batches(c=6, seed=0):
    """Two NHWC batches of 6 rows whose last two rows repeat the fourth (a
    padded client's rows), far from zero mean, and a row mask."""
    rs = np.random.RandomState(seed)
    out = []
    for shift in (0.7, -0.4):
        x = (1.5 * rs.randn(6, 4, 4, c) + shift).astype(np.float32)
        x[4:] = x[3]
        out.append(x)
    return out, np.array([1, 1, 1, 1, 0, 0], np.float32)


def _flax_layer_run(x1, x2, mask, scale, bias, dtype):
    layer = fnn.BatchNorm(use_running_average=False, momentum=0.9, dtype=dtype)
    stats = {"mean": np.zeros_like(scale), "var": np.ones_like(scale)}
    outs = []

    def loss(params, x, stats):
        y, upd = layer.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x, dtype), mutable=["batch_stats"])
        per = jnp.sum(jnp.sin(y.astype(jnp.float32)), axis=(1, 2, 3))
        return jnp.sum(per * mask) / jnp.sum(mask), (y, upd)

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    for x in (x1, x2):
        (_, (y, upd)), (gp, gx) = step({"scale": scale, "bias": bias}, x, stats)
        stats = jax.tree_util.tree_map(np.asarray, upd["batch_stats"])
        outs.append((np.asarray(y, np.float32), stats, np.asarray(gx),
                     np.asarray(gp["scale"]), np.asarray(gp["bias"])))
    ye = fnn.BatchNorm(use_running_average=True, momentum=0.9, dtype=dtype).apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": stats},
        jnp.asarray(x1, dtype))
    return outs, np.asarray(ye, np.float32)


def _port_layer_run(x1, x2, mask, scale, bias, dtype):
    layer = resnet.BatchNorm(scale.shape[0], dtype)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(scale))
        layer.bias.copy_(torch.from_numpy(bias))
    layer.train()
    outs = []
    for x in (x1, x2):
        xt = _nchw(x).to(dtype).requires_grad_()
        y = layer(xt)
        per = torch.sin(y.float()).sum(dim=(1, 2, 3))
        m = torch.from_numpy(mask)
        loss = (per * m).sum() / m.sum()
        layer.weight.grad = layer.bias.grad = None
        loss.backward()
        outs.append((_nhwc(y), {"mean": layer.mean.numpy().copy(),
                                "var": layer.var.numpy().copy()},
                     _nhwc(xt.grad), layer.weight.grad.numpy().copy(),
                     layer.bias.grad.numpy().copy()))
    layer.eval()
    with torch.no_grad():
        ye = _nhwc(layer(_nchw(x1).to(dtype)))
    return outs, ye


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layer_matches_flax_batchnorm(dtype):
    (x1, x2), mask = _layer_batches()
    rs = np.random.RandomState(1)
    scale = (1.0 + 0.1 * rs.randn(6)).astype(np.float32)
    bias = (0.1 * rs.randn(6)).astype(np.float32)
    jd, td = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    if dtype == "bf16":  # both sides take the same bf16 inputs
        x1, x2 = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32) for x in (x1, x2))
    want, want_eval = _flax_layer_run(x1, x2, mask, scale, bias, jd)
    got, got_eval = _port_layer_run(x1, x2, mask, scale, bias, td)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in ("mean", "var"):  # fp32 in both types
            np.testing.assert_allclose(g[1][k], w[1][k], rtol=0, atol=1e-5,
                                       err_msg=f"step {step} {k}")
        if dtype == "fp32":
            for i, what in ((0, "y"), (2, "dx"), (3, "dscale"), (4, "dbias")):
                np.testing.assert_allclose(g[i], w[i], rtol=0, atol=1e-5,
                                           err_msg=f"step {step} {what}")
        else:
            bound = 2.0 ** -8 * np.abs(w[0]).max()
            assert np.abs(g[0] - w[0]).max() <= bound, step
    bound = 1e-5 if dtype == "fp32" else 2.0 ** -8 * np.abs(want_eval).max()
    assert np.abs(got_eval - want_eval).max() <= bound


def test_torch_batchnorm_rules_miss_the_bound():
    """torch's own rules, planted: the unbiased running variance, and flax's
    momentum 0.9 read as torch's (ra = 0.1 ra + 0.9 batch)."""
    (x1, _), mask = _layer_batches()
    c = x1.shape[-1]
    _, upd = fnn.BatchNorm(use_running_average=False, momentum=0.9).apply(
        {"params": {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)},
         "batch_stats": {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}},
        x1, mutable=["batch_stats"])
    want = jax.tree_util.tree_map(np.asarray, upd["batch_stats"])
    for momentum in (0.1, 0.9):
        rm, rv = torch.zeros(c), torch.ones(c)
        torch.nn.functional.batch_norm(_nchw(x1), rm, rv, training=True, momentum=momentum)
        miss = max(np.abs(rm.numpy() - want["mean"]).max(), np.abs(rv.numpy() - want["var"]).max())
        assert miss > 1e-5, momentum
    layer = resnet.BatchNorm(c)
    with torch.no_grad():
        layer.weight.fill_(1.0)
        layer.bias.zero_()
    layer.train()(_nchw(x1))
    np.testing.assert_allclose(layer.var.numpy(), want["var"], rtol=0, atol=1e-5)
    assert dict(layer.named_buffers()).keys() == {"mean", "var"}  # no num_batches_tracked


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _models(name, float64=False):
    if name == "resnet20":
        if float64:
            return (jresnet.resnet20(10, norm="bn", dtype=jnp.float64),
                    resnet.resnet20(10, norm="bn", dtype=torch.float64, device="meta"))
        args = type("A", (), {"model": "resnet20", "dataset": "cifar10", "model_norm": "bn"})()
        return jresnet.resnet20(10, norm="bn"), hub.create(args, 10)
    return (jmobilenet.MobileNetV1(10, width=0.25, norm="bn"),
            mobilenet.MobileNetV1(10, width=0.25, norm="bn", device="meta"))


# (image side, batch, the port's dtype, gradients too): the JAX function runs
# in float64.  BatchNorm's gradients are the layer test's and ResNet-20's;
# the MobileNet adds its depthwise wiring, held in its training forward (the
# logits and every running average) and its eval.
# ResNet-20 on 16 images of 32x32: the port in float64 must equal it (1e-9
# of each leaf's largest entry); in fp32 its gradient is held within 5e-2 of
# that, as BatchNorm's backward leaves whole channels' gradients a few percent
# of their parts (the conditioning the rounds' tolerance rests on).
# MobileNetV1's last BatchNorms, on 2x2 and 1x1 maps, see 32 and 8 values a
# channel, whose batch variance can be small against the mean's square;
# there flax's fp32 E[x^2] - E[x]^2 loses digits, so the port in fp32 is
# held to the JAX function in float64 at 1e-4, as the deep GroupNorm nets
# are.
MODEL_CASES = {"resnet20": (32, 16, torch.float64, True),
               "mobilenet": (16, 8, torch.float32, False)}
MODEL_BOUND = {torch.float64: 1e-9, torch.float32: 1e-4}


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_model_matches_flax(name):
    side, n, tdtype, grads_too = MODEL_CASES[name]
    jmod, tmod = _models(name, float64=tdtype is torch.float64)
    rs = np.random.RandomState(2)
    x = (rs.randn(n, side, side, 3) + 0.3).astype(np.float32)
    y = rs.randint(0, 10, size=n).astype(np.int32)
    jvars = _filled(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x[:1]), seed=3)
    assert set(jvars) == {"params", "batch_stats"}

    def jrun(variables, x):
        def loss(params):  # the mean CE in the logits' dtype
            logits, upd = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                     x, train=True, mutable=["batch_stats"])
            picked = jnp.take_along_axis(logits, y[:, None], axis=-1)[:, 0]
            return jnp.mean(jax.nn.logsumexp(logits, axis=-1) - picked), (logits, upd)
        if not grads_too:
            _, (logits, upd) = loss(variables["params"])
            return logits, upd, None, jmod.apply(variables, x, train=False)
        (_, (logits, upd)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
        return logits, upd, grads, jmod.apply(variables, x, train=False)

    with jax.enable_x64(True):
        jlogits, jupd, jgrads, jeval = jax.tree_util.tree_map(np.asarray, jax.jit(jrun)(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jvars),
            x.astype(np.float64)))
    want = convert.params_state_from_flax({"params": jgrads or {},
                                           "batch_stats": jupd["batch_stats"]})

    def run(module, dtype):
        module.to_empty(device="cpu")
        module.init_parameters(torch.Generator().manual_seed(0))
        module.to(dtype)
        start = convert.variables_from_flax(jvars, module, CPU)
        load_variables(module, start)
        module.train()
        logits = module(torch.from_numpy(x).to(dtype))
        torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long()).backward()
        got = {k: p.grad.double().numpy() for k, p in module.named_parameters()
               if grads_too}
        got.update({k: b.double().numpy().copy() for k, b in module.named_buffers()})
        load_variables(module, start)  # the eval reads the tree's running averages
        with torch.no_grad():
            ev = module.eval()(torch.from_numpy(x).to(dtype)).double().numpy()
        return logits.detach().double().numpy(), got, ev

    logits, got, ev = run(tmod, tdtype)
    assert sorted(got) == sorted(want)
    assert sorted(k for k, _ in tmod.named_buffers()) == sorted(
        convert.params_state_from_flax({"params": {}, "batch_stats": jvars["batch_stats"]}))
    bound = MODEL_BOUND[tdtype]
    assert _rel(logits, jlogits) <= bound and _rel(ev, jeval) <= bound
    for k in want:
        assert _rel(got[k], want[k]) <= bound, (k, _rel(got[k], want[k]))
    if tdtype is torch.float64:  # the hub's fp32 module on the same tree
        _, fp32 = _models(name)
        logits, got, ev = run(fp32, torch.float32)
        assert _rel(logits, jlogits) <= 1e-5 and _rel(ev, jeval) <= 1e-5
        stats = [k for k in want if convert.is_batch_stat(k)]
        assert max(_rel(got[k], want[k]) for k in stats) <= 1e-5
        assert max(_rel(got[k], want[k]) for k in want) <= 5e-2


def test_hub_wiring_follows_jax():
    """``model_norm`` reaches resnet20/resnet56; resnet18 and the MobileNets
    keep GroupNorm through the hub, as the JAX hub builds them."""
    args = type("A", (), {"dataset": "cifar10", "model_norm": "bn"})()
    for name, bn in (("resnet20", True), ("resnet56", True), ("resnet18", False),
                     ("mobilenet", False), ("mobilenet_v3", False)):
        args.model = name
        norms = {type(m) for m in hub.create(args, 10).modules()} & {resnet.BatchNorm,
                                                                     resnet.GroupNorm}
        assert norms == {resnet.BatchNorm if bn else resnet.GroupNorm}, name
    v3 = mobilenet.MobileNetV3Small(10, norm="bn", device="meta")
    assert {n.rsplit(".", 1)[-1] for n, _ in v3.named_buffers()} == {"mean", "var"}


class _Stray(torch.nn.Module):
    """A module whose buffer or parameter names break ``is_batch_stat``."""

    def __init__(self, kind):
        super().__init__()
        self.lin = torch.nn.Linear(2, 2)
        if kind == "buffer":
            self.register_buffer("step", torch.zeros(()))
        else:
            self.mean = torch.nn.Parameter(torch.zeros(2))


@pytest.mark.parametrize("kind", ["buffer", "parameter"])
def test_module_state_refuses_names_the_batch_stat_rule_misreads(kind):
    """A buffer that is not a running average would enter the variables as a
    parameter (and the server steps would act on it); a parameter named
    ``mean`` would be left out of them.  ``module_state`` refuses both, and
    with it ``variables_from_flax`` and the engines."""
    with pytest.raises(ValueError, match="is_batch_stat"):
        convert.module_state(_Stray(kind))
    with pytest.raises(ValueError, match="is_batch_stat"):
        get_variables(_Stray(kind))
    bn = resnet.BatchNorm(3)
    assert [n for n, _ in convert.module_state(bn)] == ["weight", "bias", "mean", "var"]


def test_flat_layout_matches_ravel_pytree():
    jmod, tmod = _models("resnet20")
    x = np.zeros((1, 8, 8, 3), np.float32)
    jvars = _filled(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x), seed=4)
    tmod.to_empty(device="cpu")
    tvars = convert.variables_from_flax(jvars, tmod, CPU)
    layout = convert.FlatLayout.of(tvars)
    want, _ = ravel_pytree(jvars)
    got = layout.ravel(tvars)
    assert layout.dim == want.shape[0]
    assert np.array_equal(got.numpy(), np.asarray(want))
    n_stats = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(jvars["batch_stats"]))
    assert all(e[1][0] == "batch_stats" for e in layout.entries if e[4] < n_stats)
    back = layout.unravel(got, tvars)
    assert all(torch.equal(back[k], tvars[k]) for k in tvars)


# ---------------------------------------------------------------------------
# the in-mesh server steps on a tree with batch_stats
# ---------------------------------------------------------------------------

MEMBERS = {
    "fedavg": {},
    "fedopt": {"federated_optimizer": "FedOpt", "server_optimizer": "adam", "server_lr": 0.1},
    "fednova": {"federated_optimizer": "FedNova"},
    "scaffold": {"federated_optimizer": "SCAFFOLD"},
    "feddyn": {"federated_optimizer": "FedDyn", "feddyn_alpha": 0.1},
    "async_fedavg": {"federated_optimizer": "Async_FedAvg"},
    "fedbuff": {"fl_mode": "async", "async_staleness_policy": "polynomial"},
}


def _bn_tree(rs):
    return {"params": {"lin": {"kernel": rs.randn(3, 2), "bias": rs.randn(2)},
                       "bn": {"scale": 1 + 0.1 * rs.randn(2), "bias": rs.randn(2)}},
            "batch_stats": {"bn": {"mean": rs.randn(2), "var": 0.5 + rs.rand(2)}}}


@pytest.mark.parametrize("member", list(MEMBERS))
def test_inmesh_server_step_matches_jax_with_batch_stats(member):
    """One round of two clients through each in-mesh strategy's contributions
    and server step, JAX's and the port's, on a tree with ``batch_stats``:
    the new global (params and running averages) within 1e-6, every
    server-state and client-output entry a parameter (``params_of``), and
    the running averages the sample-weighted mean wherever the strategy
    aggregates through ``acc``."""
    from fedml_tpu.ml.engine.train import LocalTrainResult as JResult
    from fedml_tpu.simulation.xla.algorithms import create_inmesh_algorithm as jcreate
    from fedml_tpu_torch.ml.engine.train import LocalTrainResult
    from fedml_tpu_torch.simulation.xla.algorithms import create_inmesh_algorithm, tree_add_

    knobs = dict(federated_optimizer="FedAvg", fl_mode="sync", client_num_in_total=4,
                 learning_rate=0.1, client_optimizer="sgd", momentum=0.0)
    knobs.update(MEMBERS[member])
    args = type("A", (), knobs)()
    rs = np.random.RandomState(7)
    f32 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    g = f32(_bn_tree(rs))
    clients = [(3.0, 2.0, f32(jax.tree_util.tree_map(lambda a: a + 0.1 * rs.randn(*a.shape), g))),
               (5.0, 3.0, f32(jax.tree_util.tree_map(lambda a: a + 0.1 * rs.randn(*a.shape), g)))]
    torch_of = lambda t: {k: torch.from_numpy(np.array(v)) for k, v in  # noqa: E731
                          convert.params_state_from_flax(t).items()}

    jalgo, talgo = jcreate(args), create_inmesh_algorithm(args)
    jstate, tstate = jalgo.init_server_state(g), talgo.init_server_state(torch_of(g))
    jcex = (jax.tree_util.tree_map(np.zeros_like, g["params"])
            if jalgo.needs_client_state else np.float32(0.0))
    tcex = ({k: torch.zeros_like(v) for k, v in torch_of({"params": g["params"]}).items()}
            if talgo.needs_client_state else np.float32(0.0))
    jext, text = jalgo.zero_contrib(g), talgo.zero_contrib(torch_of(g))
    jacc = jax.tree_util.tree_map(np.zeros_like, g)
    tacc = {k: torch.zeros_like(v) for k, v in torch_of(g).items()}
    for w, steps, tree in clients:
        jres = JResult(tree, np.float32(0.0), np.float32(w), np.float32(steps))
        jext = jax.tree_util.tree_map(jnp.add, jext, jalgo.client_contrib(
            g, jres, np.float32(w), np.float32(1.0), jcex, jstate))
        jacc = jax.tree_util.tree_map(lambda a, v: a + w * v, jacc, tree)
        tres = LocalTrainResult(torch_of(tree), None, w, steps)
        contrib, out = talgo.client_result(torch_of(g), tres, w, 1.0, tcex, tstate)
        text = tree_add_(text, contrib)
        for k, v in tres.variables.items():
            tacc[k].add_(v, alpha=w)
        if out is not None:
            assert not any(convert.is_batch_stat(k) for k in out)
    jnew, _ = jalgo.server_update(jacc, np.float32(8.0), jext, g, jstate)
    tnew, tstate = talgo.server_update(tacc, 8.0, text, torch_of(g), tstate)
    want = convert.params_state_from_flax(jax.tree_util.tree_map(np.asarray, jnew))
    assert sorted(tnew) == sorted(want)
    for k in want:
        np.testing.assert_allclose(tnew[k].numpy(), want[k], rtol=0, atol=1e-6, err_msg=k)
    def names(tree):
        if not isinstance(tree, dict):
            return []
        return [k for k, v in tree.items() if torch.is_tensor(v)] + [
            n for v in tree.values() for n in names(v)]

    assert not any(convert.is_batch_stat(k) for k in names(tstate))
    if member in ("fedopt", "scaffold", "feddyn"):  # their state: the params alone
        assert sorted(set(names(tstate))) == sorted(
            k for k in tnew if not convert.is_batch_stat(k))
    if talgo.aggregates_via_acc:
        for k in ("bn.mean", "bn.var"):
            mean = sum(w * torch_of(t)[k] for w, _, t in clients) / 8.0
            np.testing.assert_allclose(tnew[k].numpy(), mean.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the freeze on all-padding steps
# ---------------------------------------------------------------------------

def test_all_padding_step_leaves_params_and_running_stats():
    args = type("A", (), {"model": "resnet20", "dataset": "cifar10", "model_norm": "bn",
                          "client_optimizer": "sgd", "learning_rate": 0.1, "epochs": 1})()
    module = hub.create(args, 10)
    module.to_empty(device="cpu")
    module.init_parameters(torch.Generator().manual_seed(0))
    init = get_variables(module)
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(8, 8, 8, 3).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, size=8).astype(np.int64))
    x[3:], y[3:] = x[0], y[0]  # rows 3-7 pad a 3-row client
    # a seed whose shuffle puts the 3 real rows in one batch of 4
    seed = next((s,) for s in range(100) if len({int(i) < 3 for i in torch.randperm(
        8, generator=shuffle_generator((s, 0)))[:4]}) == 1)
    perm = torch.randperm(8, generator=shuffle_generator((*seed, 0)))
    batch = perm[:4] if int((perm[:4] < 3).sum()) == 3 else perm[4:]
    padded = build_local_train(module, args, 4, 8)(init, x, y, 3, seed=seed)
    assert padded.steps == 1.0 and padded.seen == 3.0
    # the same real batch as a client of one batch: its rows valid first
    rows = torch.cat([batch[batch < 3], batch[batch >= 3]])
    alone = build_local_train(module, args, 4, 4)(init, x[rows], y[rows], 3, seed=seed)
    assert alone.steps == 1.0
    for k in init:
        np.testing.assert_allclose(padded.variables[k].numpy(), alone.variables[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    moved = [k for k in init if convert.is_batch_stat(k)
             and not torch.equal(alone.variables[k], init[k])]
    assert len(moved) == sum(convert.is_batch_stat(k) for k in init)


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------

RUN_CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "cifar10", "partition_method": "hetero", "partition_alpha": 0.5,
                  "synthetic_train_size": 40},
    "model_args": {"model": "resnet20", "model_norm": "bn"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 4,
                   "client_num_per_round": 3, "comm_round": 1, "epochs": 1,
                   "batch_size": 16, "client_optimizer": "sgd", "learning_rate": 0.001},
    "validation_args": {"frequency_of_the_test": 0, "eval_batch_size": 8},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "XLA"},
}
RUNS = {
    "padded": ({}, {}),
    "packed": ({"xla_pack": True, "batch_size": 4}, {}),
    "sp_fedavg": ({}, {"backend": "sp"}),
    "sp_fedopt": ({"federated_optimizer": "FedOpt", "server_optimizer": "adam",
                   "server_lr": 0.01}, {"backend": "sp"}),
}
# the JAX sp runs' jitted functions, shared (the two members train alike)
_JAX_FNS = {}


def _config(run):
    train, comm = RUNS[run]
    config = copy.deepcopy(RUN_CONFIG)
    config["train_args"].update(train)
    config["comm_args"].update(comm)
    if comm:
        config["validation_args"]["frequency_of_the_test"] = 1
    return config


def _jax_run(run):
    """The JAX package's global variables after the round, its init and its
    eval (sp)."""
    from fedml_tpu.ml.aggregator import default_aggregator as jagg
    from fedml_tpu.ml.trainer.cls_trainer import ModelTrainerCLS as JTrainer
    from fedml_tpu.parallel.mesh import create_fl_mesh
    from fedml_tpu.simulation.xla import fed_sim as jfed_sim
    from test_torch_packed import _filled_init

    config = _config(run)
    args = fedml_tpu.init(fedml_tpu.Arguments.from_dict(config), should_init_logs=False)
    dataset, classes = fedml_tpu.data.data_loader.load(args)
    model = fedml_tpu.models.hub.create(args, classes)
    fn_for, make_eval_fn = JTrainer._fn_for, jagg.make_eval_fn
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfed_sim, "init_variables", _filled_init)
        _cheap_jax_host(mp)
        mp.setattr(JTrainer, "_fn_for", lambda t, n, b: _JAX_FNS.setdefault(
            ("train", n, b), fn_for(t, n, b)))
        mp.setattr(jagg, "make_eval_fn", lambda m: _JAX_FNS.setdefault(
            "eval", make_eval_fn(m)))
        if config["comm_args"]["backend"] == "sp":
            runner = fedml_tpu.FedMLRunner(args, fedml_tpu.device.get_device(args), dataset,
                                           model)
            api = runner.runner.fl_trainer
            init = jax.tree_util.tree_map(np.asarray, api.w_global)
            final = runner.run()
            out = api.w_global
        else:
            sim = jfed_sim.XLASimulator(args, dataset, model,
                                        mesh=create_fl_mesh(devices=jax.devices()[:1]))
            init = jax.tree_util.tree_map(np.asarray, sim.variables)
            final = sim.train()
            out = sim.variables
    return convert.params_state_from_flax(jax.tree_util.tree_map(np.asarray, out)), init, final


def _port_run(run, init):
    config = _config(run)
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(config),
                                should_init_logs=False)
    device = fedml_tpu_torch.device.get_device(args)
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, classes)
    runner = fedml_tpu_torch.FedMLRunner(args, device, dataset, model)
    start = convert.variables_from_flax(init, model, device)
    if config["comm_args"]["backend"] == "sp":
        api = runner.runner.fl_trainer
        api.w_global = start
        api.aggregator.set_model_params(start)
        final = runner.run()
        out = api.w_global
    else:
        sim = runner.runner.sim
        sim.variables = start
        sim.server_state = sim.algo.init_server_state(start)
        final = runner.run()
        out = sim.variables
        assert sim.packed == (run == "packed")
    return {k: v.numpy() for k, v in out.items()}, final


@pytest.mark.parametrize("run", list(RUNS))
def test_round_matches_jax(run):
    want, init, want_eval = _jax_run(run)
    got, got_eval = _port_run(run, init)
    assert sorted(got) == sorted(want)
    assert sum(convert.is_batch_stat(k) for k in got) == 2 * 21  # 21 BatchNorms
    start = convert.params_state_from_flax(init)
    for k in want:
        assert not np.array_equal(want[k], start[k]), k  # the round moved every entry
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-5, err_msg=f"{run} {k}")
    if RUNS[run][1]:
        assert got_eval["round"] == want_eval["round"] == 0
        for key in ("test_acc", "test_loss"):  # each rounded to 4 decimals
            bound = 1e-4 + 1e-4 * abs(want_eval[key])
            assert round(abs(got_eval[key] - want_eval[key]), 8) <= bound, key
