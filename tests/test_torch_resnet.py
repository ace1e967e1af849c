"""The port's ResNets against the JAX package's flax ResNets, from the same
transplanted weights and the same numpy inputs (NHWC, 8x8 or 16x16).

Tolerances:

* fp32 logits and every parameter's gradient: atol 1e-5 + rtol 1e-4 (the
  two sum in other orders; they read about 1e-6).
* bf16 logits: within 2e-2 of max |logit| (each convolution, norm output
  and residual add rounds to bf16 on both sides, in other orders; they read
  0.9-1.3e-2 of it).
* bf16 gradients: at this size bf16 rounding alone moves the gradient
  (all leaves as one vector) 3-14 % in norm off the fp32 gradient, on both
  sides, and XLA's fused bf16 ops round less often than torch's op by op.
  So the port's bf16 gradient must be no farther from the fp32 one than
  twice the JAX bf16 gradient is (the ratio read 0.4-1.3 over 3 draws of
  weights a model), and within 0.25 in norm of the JAX bf16 gradient (read
  0.06-0.14).
* The stride-2 padding, GroupNorm's epsilon and its groups are each held at
  atol 1e-5 and shown to fail that with the naive torch choice planted.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ml.engine.train import softmax_ce_loss as jloss
from fedml_tpu.models import resnet as jresnet
from fedml_tpu_torch.ml.engine.train import load_variables, softmax_ce_loss as tloss
from fedml_tpu_torch.models import convert, hub, resnet


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FP32_TOL = dict(atol=1e-5, rtol=1e-4)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _batch(n=4, size=8, channels=3, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, size, size, channels).astype(np.float32),
            rs.randint(0, 10, size=n).astype(np.int32), np.ones(n, np.float32))


def _params(jmodule, x, seed):
    """flax variables of ``jmodule``'s shapes (``jax.eval_shape``: no init to
    compile), drawn from numpy: kernels N(0, 1/fan_in), GroupNorm scales
    1 + N(0, 0.1^2) and biases N(0, 0.1^2), so the norms' affine terms count."""
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), x[:1])
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        z = rs.randn(*leaf.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        return (1.0 if path[-1].key == "scale" else 0.0) + 0.1 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_like(jvars, tmodule):
    """Materialise ``tmodule`` on the CPU and load the flax weights into it."""
    tmodule.to_empty(device="cpu")
    tmodule.init_parameters(torch.Generator().manual_seed(0))
    load_variables(tmodule, convert.variables_from_flax(
        jax.tree_util.tree_map(np.asarray, jvars), tmodule, torch.device("cpu")))
    return tmodule


def _logits_and_grads(blocks, dtype_name, jparams):
    """(logits, {torch name: grad}) of both sides for one batch."""
    jdt, tdt = DTYPES[dtype_name]
    x, y, m = _batch()
    jm = jresnet.CifarResNet(num_blocks=blocks, dtype=jdt)

    def loss(p):
        logits = jm.apply({"params": p}, x)
        return jloss(logits, y, m)[0], logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)
    tm = _port_like({"params": jparams}, resnet.CifarResNet(blocks, dtype=tdt, device="meta"))
    tlogits = tm(torch.from_numpy(x))
    tloss(tlogits, torch.from_numpy(y), torch.from_numpy(m))[0].backward()
    jg = convert.params_state_from_flax(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jgrads))
    return ((tlogits.detach().float().numpy(), np.asarray(jlogits, np.float32)),
            {n: (p.grad.numpy(), jg[n]) for n, p in tm.named_parameters()})


@pytest.fixture(scope="module", params=[1, 3], ids=["resnet8", "resnet20"])
def model_runs(request):
    blocks = request.param
    x, _, _ = _batch()
    jparams = _params(jresnet.CifarResNet(num_blocks=blocks), x, blocks)["params"]
    return {name: _logits_and_grads(blocks, name, jparams) for name in DTYPES}


def test_fp32_logits_and_gradients_match(model_runs):
    (tl, jl), grads = model_runs["fp32"]
    np.testing.assert_allclose(tl, jl, **FP32_TOL)
    for name, (tg, jg) in grads.items():
        np.testing.assert_allclose(tg, jg, **FP32_TOL, err_msg=name)


def test_bf16_logits_within_bound(model_runs):
    (tl, jl), _ = model_runs["bf16"]
    assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max()


def test_bf16_gradients_within_bound(model_runs):
    _, grads = model_runs["bf16"]
    _, ref = model_runs["fp32"]

    def flat(gs, i):
        return np.concatenate([g[i].ravel() for g in gs.values()])

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    port, jax_bf16, fp32 = flat(grads, 0), flat(grads, 1), flat(ref, 1)
    assert rel(port, fp32) <= 2.0 * rel(jax_bf16, fp32), (rel(port, fp32), rel(jax_bf16, fp32))
    assert rel(port, jax_bf16) <= 0.25


def _block_outputs():
    """A lone stride-2 BasicBlock (16 -> 32 channels, 8x8 -> 4x4), fp32."""
    x = np.random.RandomState(3).randn(2, 8, 8, 16).astype(np.float32)
    jb = jresnet.BasicBlock(filters=32, stride=2)
    jvars = jax.jit(jb.init)(jax.random.PRNGKey(0), x)
    tb = resnet.BasicBlock(16, 32, 2, device="meta")
    tb.to_empty(device="cpu")
    # a block's leaves are mapped under the name of the block that holds them
    params = {"b": jax.tree_util.tree_map(np.asarray, jvars)["params"]}
    state = {k[2:]: v for k, v in convert.params_state_from_flax(params).items()}
    load_variables(tb, {k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    out = tb(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return out.detach().numpy(), np.asarray(jb.apply(jvars, x))


def test_stride2_block_pads_like_flax():
    got, want = _block_outputs()
    assert got.shape == want.shape == (2, 4, 4, 32)
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_planted_symmetric_padding_fails(monkeypatch):
    """torch's padding=1 on the stride-2 convolution, (1, 1) where flax pads
    (0, 1): the block's output leaves the tolerance by far."""
    monkeypatch.setattr(resnet, "_same_pads", lambda size, k, stride: ((k - 1) // 2,) * 2)
    got, want = _block_outputs()
    assert np.abs(got - want).max() > 100 * FP32_TOL["atol"]


@pytest.mark.parametrize("channels", [16, 32, 64])
def test_group_norm_epsilon_and_groups(channels):
    # a variance near 1e-6, so that epsilon 1e-6 and torch's default 1e-5
    # differ; zero mean, where flax's E[x^2] - E[x]^2 loses nothing
    x = (1e-3 * np.random.RandomState(channels).randn(2, 4, 4, channels)).astype(np.float32)
    jgn = fnn.GroupNorm(num_groups=None, group_size=16)
    jvars = jgn.init(jax.random.PRNGKey(0), x)
    want = np.asarray(jgn.apply(jvars, x))
    tgn = resnet.GroupNorm(channels)
    assert (tgn.num_groups, tgn.eps) == (channels // 16, 1e-6)
    with torch.no_grad():
        tgn.weight.fill_(1.0)
        tgn.bias.zero_()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tgn(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, **FP32_TOL)
    tgn.eps = 1e-5  # torch's default
    naive = tgn(xt).permute(0, 2, 3, 1).detach().numpy()
    assert np.abs(naive - want).max() > 100 * FP32_TOL["atol"]
    if channels > 16:  # one group over all channels is another function
        tgn.eps, tgn.num_groups = 1e-6, 1
        one = tgn(xt).permute(0, 2, 3, 1).detach().numpy()
        assert np.abs(one - want).max() > 100 * FP32_TOL["atol"]


def test_group_norm_bf16_normalises_in_fp32():
    """flax GroupNorm(dtype=bf16) on bf16 input: fp32 statistics and
    normalisation, the result rounded to bf16: equal up to one bf16 step."""
    x = np.random.RandomState(5).randn(2, 4, 4, 32).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jgn = fnn.GroupNorm(num_groups=None, group_size=16, dtype=jnp.bfloat16)
    want = jgn.apply(jgn.init(jax.random.PRNGKey(0), xb), xb)
    assert want.dtype == jnp.bfloat16
    tgn = resnet.GroupNorm(32, dtype=torch.bfloat16)
    with torch.no_grad():
        tgn.weight.fill_(1.0)
        tgn.bias.zero_()
    got = tgn(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().permute(0, 2, 3, 1).numpy(), want,
                               atol=2 ** -8, rtol=2 ** -8)


@pytest.mark.parametrize("small_images", [True, False])
def test_resnet18_forward_matches(small_images):
    """ResNet-18 in fp32, both stems (the 7x7 stride-2 one pads (2, 3) and
    its max-pool pads with -inf)."""
    x, _, _ = _batch(n=2, size=16)
    jm = jresnet.ResNet18(num_classes=100, small_images=small_images)
    jvars = _params(jm, x, 0)
    tm = _port_like(jvars, resnet.ResNet18(100, small_images=small_images, device="meta"))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jm.apply)(jvars, x)), **FP32_TOL)


@pytest.mark.parametrize("name", ["resnet20", "resnet56", "resnet18"])
def test_convert_round_trips_every_leaf(name):
    """Every flax leaf maps to one torch parameter of its shape, and its
    values come back bit for bit (shapes from ``jax.eval_shape``, values
    drawn per leaf)."""
    jm = {"resnet20": jresnet.resnet20, "resnet56": jresnet.resnet56,
          "resnet18": jresnet.resnet18_gn}[name]()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rs = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(lambda s: rs.randn(*s.shape).astype(np.float32), shapes)
    leaves = jax.tree_util.tree_leaves_with_path(tree["params"])
    tm = hub.create(type("A", (), {"model": name, "dataset": "cifar10"})(),
                    100 if name == "resnet18" else 10)
    state = convert.variables_from_flax(tree, tm, torch.device("cpu"))
    assert len(state) == len(leaves) == len(list(tm.parameters()))
    for path, leaf in leaves:
        keys = [p.key for p in path]
        module = ".".join(keys[:-1])
        if keys[-1] == "kernel" and leaf.ndim == 4:
            back = state[f"{module}.weight"].numpy().transpose(2, 3, 1, 0)
        elif keys[-1] == "kernel":
            back = state[f"{module}.weight"].numpy().T
        else:
            back = state[f"{module}.{'weight' if keys[-1] == 'scale' else 'bias'}"].numpy()
        assert np.array_equal(back, leaf), keys


def test_hub_builds_resnets_and_refuses_batchnorm():
    args = type("A", (), {"model": "resnet56", "dataset": "cifar10", "compute_dtype": "bf16"})()
    model = hub.create(args, 10)
    assert isinstance(model, resnet.CifarResNet) and model.dtype is torch.bfloat16
    assert all(p.is_meta and p.dtype is torch.float32 for p in model.parameters())
    assert hub.data_storage_dtype(args, model) is torch.bfloat16
    assert hub.data_storage_dtype(args, resnet.resnet56(device="meta")) is torch.float32
    args.xla_data_dtype = "fp32"
    assert hub.data_storage_dtype(args, model) is torch.float32
    args.model_norm = "bn"
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        hub.create(args, 10)
