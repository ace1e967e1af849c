"""The port's ring attention and sequence-parallel TransformerLM against the
JAX package's.

The JAX side runs as tests/test_long_context.py runs it: Pallas in interpret
mode, and rings over a mesh of 4 of the 8 virtual CPU devices
(``fedml_tpu.parallel.mesh.create_mesh((4,), ("sp",))``).  The port runs its
plain versions on CPU tensors: K4's plain twin inside the ring, through the
autograd Function whose backward recomputes through
``shard_update_reference``.  Both sides take the same seeded numpy inputs,
and the port takes the flax weights through ``models/convert.py``.  All fp32.

Tolerances, those of tests/test_long_context.py for the same comparisons:

* one shard fold (m, l, o) and the fused reference fold: atol 2e-5;
* gradients through one fold, for q, k, v, m, l and o: atol 1e-4;
* ring attention at n = 4: forward atol 2e-5, gradients atol 5e-4;
* ``sp_apply`` logits: atol 3e-4;
* ``sp_loss_fn``: the loss to rtol 1e-5, every parameter's gradient to atol
  1e-4.

Each JAX ring or ``sp_*`` result is computed once, in a module-scope fixture.
"""

import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.transformer import TransformerConfig as JCfg
from fedml_tpu.ops.flash_attention import flash_shard_update as jax_fold
from fedml_tpu.ops.flash_attention import shard_update_reference as jax_reference_fold
from fedml_tpu.parallel import seq_parallel as jsp
from fedml_tpu.parallel.mesh import create_mesh as jax_create_mesh
from fedml_tpu.parallel.ring_attention import pallas_block_attend, ring_attention as jax_ring
from fedml_tpu_torch.ml.engine.train import make_optimizer
from fedml_tpu_torch.models import convert
from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from fedml_tpu_torch.ops import flash_attention as fa
from fedml_tpu_torch.parallel import seq_parallel as psp
from fedml_tpu_torch.parallel.mesh import create_mesh
from fedml_tpu_torch.parallel.ring_attention import _block_attend, ring_attention


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = torch.device("cpu")
B, H, D = 2, 2, 8
# name: (causal, Lq, Lk, q offset, k offset, padded key tail, carried state).
# Lq != Lk and both ragged against the Pallas blocks of 16; "dead" is a ring
# step whose keys all come after the rows; in "causal_fresh" the first rows
# see no key at all and keep m = -inf.
FOLDS = {
    "causal_partial": (True, 24, 40, 32, 16, 5, True),
    "full_padded": (False, 24, 40, 32, 16, 5, True),
    "dead": (True, 24, 40, 0, 64, 0, True),
    "causal_fresh": (True, 24, 40, 8, 16, 0, False),
}


def _fold_inputs(name):
    causal, Lq, Lk, q_off, k_off, tail, carried = FOLDS[name]
    rs = np.random.RandomState(sorted(FOLDS).index(name))
    q = rs.randn(B, Lq, H, D).astype(np.float32) * 0.5
    k, v = (rs.randn(B, Lk, H, D).astype(np.float32) * 0.5 for _ in range(2))
    q_pos = (q_off + np.arange(Lq)).astype(np.int32)
    k_pos = (k_off + np.arange(Lk)).astype(np.int32)
    if tail:
        k_pos[-tail:] = -1
    m = np.full((B, H, Lq), -np.inf, np.float32)
    l = np.zeros((B, H, Lq), np.float32)
    o = np.zeros((B, Lq, H, D), np.float32)
    if carried:  # the state after the rows' own shard, as at ring step 0
        t = torch.from_numpy
        m, l, o = (x.numpy() for x in fa.shard_update_reference(
            t(q), t(q * 0.9), t(q * 1.1), t(q_pos), t(q_pos), True, t(m), t(l), t(o)))
    return (q, k, v, q_pos, k_pos, m, l, o), causal


def _weights(name):
    Lq = FOLDS[name][1]
    rs = np.random.RandomState(100)
    return (rs.randn(B, H, Lq).astype(np.float32), rs.randn(B, H, Lq).astype(np.float32),
            rs.randn(B, Lq, H, D).astype(np.float32))


def _fold_loss(m, l, o, w, where):
    """A scalar of all three outputs; rows with m = -inf enter through 0."""
    wm, wl, wo = w
    return (where(m > -np.inf, m, 0.0) * wm).sum() + (l * wl).sum() + (o * wo).sum()


@pytest.mark.parametrize("name", sorted(FOLDS))
def test_fold_matches_pallas(name):
    args, causal = _fold_inputs(name)
    fold = jax.jit(partial(jax_fold, causal=causal, block_q=16, block_k=16, interpret=True))
    want = fold(*(jnp.asarray(a) for a in args))
    got = fa.flash_shard_update(*(torch.from_numpy(a) for a in args), causal)
    for key, g, w in zip("mlo", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, err_msg=key)
    if name == "dead":  # nothing live: the carried state passes through
        for g, a in zip(got, args[5:]):
            np.testing.assert_array_equal(g.numpy(), a)


@pytest.mark.parametrize("name", sorted(FOLDS))
def test_reference_fold_matches_jax(name):
    (q, k, v, q_pos, k_pos, m, l, o), causal = _fold_inputs(name)
    want = jax_reference_fold(*(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)), causal,
                              *(jnp.asarray(a) for a in (m, l, o)))
    t = torch.from_numpy
    got = fa.shard_update_reference(t(q), t(k), t(v), t(q_pos), t(k_pos), causal, t(m), t(l),
                                    t(o))
    for key, g, w in zip("mlo", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, err_msg=key)


@pytest.mark.parametrize("name", ["causal_partial", "dead", "causal_fresh"])
def test_fold_gradients_match_pallas(name):
    args, causal = _fold_inputs(name)
    w = _weights(name)
    q, k, v, q_pos, k_pos, m, l, o = args

    def loss_j(q, k, v, m, l, o):
        out = jax_fold(q, k, v, jnp.asarray(q_pos), jnp.asarray(k_pos), m, l, o,
                       causal=causal, block_q=16, block_k=16, interpret=True)
        return _fold_loss(*out, w, jnp.where)

    grads_j = jax.jit(jax.grad(loss_j, argnums=tuple(range(6))))(
        *(jnp.asarray(a) for a in (q, k, v, m, l, o)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, m, l, o)]
    out = fa.flash_shard_update(*leaves[:3], torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                                *leaves[3:], causal)
    _fold_loss(*out, tuple(torch.from_numpy(x) for x in w), torch.where).backward()
    for key, t, gj in zip(("q", "k", "v", "m", "l", "o"), leaves, grads_j):
        assert bool(t.grad.isfinite().all()), key
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), atol=1e-4, err_msg=f"d{key}")
    if name == "dead":  # no live key: q, k and v get zero gradients
        for t in leaves[:3]:
            assert not bool(t.grad.any())


# ---------------------------------------------------------------------------
# the ring at n = 4
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_mesh():
    return jax_create_mesh((4,), ("sp",))


@pytest.fixture(scope="module")
def mesh():
    return create_mesh((4,), ("sp",), CPU)


def _qkvw(L=32, seed=23):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(1, L, H, D).astype(np.float32) * 0.5 for _ in range(4))


@pytest.fixture(scope="module")
def jax_ring_causal(jax_mesh):
    """JAX ring attention through the Pallas fold: the causal output and the
    gradient in q of sum(out * w)."""
    q, k, v, w = (jnp.asarray(a) for a in _qkvw())
    bf = partial(pallas_block_attend, block_q=8, block_k=8, interpret=True)

    def ring(q_):
        return jax_ring(q_, k, v, jax_mesh, axis_name="sp", causal=True, block_fn=bf)

    out = jax.jit(ring)(q)
    dq = jax.jit(jax.grad(lambda q_: jnp.sum(ring(q_) * w)))(q)
    return np.asarray(out), np.asarray(dq)


def test_ring_matches_jax_ring_with_pallas_folds(jax_ring_causal, mesh):
    out_j, dq_j = jax_ring_causal
    q, k, v, w = (torch.from_numpy(a) for a in _qkvw())
    q.requires_grad_()
    out = ring_attention(q, k, v, mesh, causal=True)
    np.testing.assert_allclose(out.detach().numpy(), out_j, atol=2e-5)
    (out * w).sum().backward()
    np.testing.assert_allclose(q.grad.numpy(), dq_j, atol=5e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_fn", ["flash", "fused"])
def test_ring_matches_flash_attention(mesh, causal, block_fn):
    """The ring at n = 4 against the port's own flash attention, forward and
    gradients, with either block function."""
    arrays = _qkvw(L=48, seed=31)
    ring_in = [torch.from_numpy(a).requires_grad_() for a in arrays[:3]]
    flash_in = [torch.from_numpy(a).requires_grad_() for a in arrays[:3]]
    w = torch.from_numpy(arrays[3])
    out = ring_attention(*ring_in, mesh, causal=causal,
                         block_fn=None if block_fn == "flash" else _block_attend)
    ref = fa.flash_attention(*flash_in, causal)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=2e-5)
    (out * w).sum().backward()
    (ref * w).sum().backward()
    for key, a, b in zip("qkv", ring_in, flash_in):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=5e-4, err_msg=f"d{key}")


# ---------------------------------------------------------------------------
# the sequence-parallel TransformerLM at sp 4
# ---------------------------------------------------------------------------
CFG = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128)


@pytest.fixture(scope="module")
def sp_variables():
    """The flax weights of the sp tests (fp32 parameters in either compute
    dtype)."""
    return jsp.sp_init(JCfg(max_seq_len=64, **CFG), seed=0)


@pytest.fixture(scope="module")
def sp_pair(jax_mesh, sp_variables):
    """JAX sp logits, loss and parameter gradients for one set of flax
    weights and tokens, and the port's parameters transplanted from them."""
    jcfg = JCfg(max_seq_len=64, **CFG)
    variables = sp_variables
    rs = np.random.RandomState(1)
    tokens = rs.randint(0, CFG["vocab_size"], size=(2, 64)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    logits = np.asarray(jax.jit(lambda p, t: jsp.sp_apply(jcfg, p, t, jax_mesh))(
        variables, jnp.asarray(tokens)))
    loss_fn = jsp.sp_loss_fn(jcfg, jax_mesh)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, jnp.asarray(tokens), jnp.asarray(targets))))(variables)
    grads = convert.transformer_state_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    cfg = TransformerConfig(**CFG)
    params = convert.variables_from_flax(jax.tree_util.tree_map(np.asarray, variables),
                                         TransformerLM(cfg, device="meta"), CPU)
    return cfg, params, tokens, targets, logits, float(loss), grads


def test_sp_apply_matches_jax(sp_pair, mesh):
    cfg, params, tokens, _, logits_j, _, _ = sp_pair
    with torch.no_grad():
        logits = psp.sp_apply(cfg, params, torch.from_numpy(tokens), mesh)
    np.testing.assert_allclose(logits.numpy(), logits_j, atol=3e-4)


def test_sp_loss_and_gradients_match_jax(sp_pair, mesh):
    cfg, params, tokens, targets, _, loss_j, grads_j = sp_pair
    params = {n: p.clone().requires_grad_() for n, p in params.items()}
    loss = psp.sp_loss_fn(cfg, mesh)(params, torch.from_numpy(tokens), torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=1e-5)
    assert sorted(params) == sorted(grads_j)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), grads_j[name], atol=1e-4, err_msg=name)


def test_sp_loss_matches_jax_in_bf16(sp_pair, sp_variables, jax_mesh, mesh):
    """In bf16 compute the per-token cross-entropy and each shard's sum are
    bf16, as optax's and jnp.sum's are in the JAX package, and only the mean
    is fp32.  So the loss times the token count is a bf16 value (a loss
    taken in fp32 is not), and it is held to the JAX sp_loss_fn on the same
    weights within one bf16 step of that total over the count (2^-7 of
    the total's leading power of two): the two forwards round their bf16
    activations in other places."""
    cfg, params, tokens, targets, _, _, _ = sp_pair
    jcfg = JCfg(max_seq_len=64, dtype=jnp.bfloat16, **CFG)
    loss_j = float(jax.jit(jsp.sp_loss_fn(jcfg, jax_mesh))(
        sp_variables, jnp.asarray(tokens), jnp.asarray(targets)))
    bcfg = TransformerConfig(dtype=torch.bfloat16, **CFG)
    tok, tgt = torch.from_numpy(tokens), torch.from_numpy(targets)
    with torch.no_grad():
        per = psp.softmax_cross_entropy(psp.sp_apply(bcfg, params, tok, mesh), tgt)
        loss = psp.sp_loss_fn(bcfg, mesh)(params, tok, tgt)
    assert per.dtype == torch.bfloat16 and loss.dtype == torch.float32
    total = float(loss) * tokens.size
    assert float(torch.tensor(total).bfloat16()) == total
    step = 2.0 ** (np.floor(np.log2(total)) - 7)
    assert abs(float(loss) - loss_j) <= step / tokens.size


def test_sp_training_steps_decrease_loss(sp_pair, mesh):
    cfg, params, tokens, targets, _, _, _ = sp_pair
    params = {n: p.clone().requires_grad_() for n, p in params.items()}
    loss_fn = psp.sp_loss_fn(cfg, mesh)
    opt = make_optimizer(types.SimpleNamespace(client_optimizer="sgd", learning_rate=0.5))(
        list(params.values()))
    tok, tgt = torch.from_numpy(tokens), torch.from_numpy(targets)
    losses = []
    for _ in range(5):
        loss = loss_fn(params, tok, tgt)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0], losses


def test_mesh_records_axis_sizes_on_one_device():
    from fedml_tpu_torch.parallel.mesh import create_train_mesh

    mesh = create_train_mesh(sp=4, device=CPU)
    assert mesh.shape == {"dp": 1, "tp": 1, "sp": 4} and mesh.device == CPU
    with pytest.raises(ValueError, match="axis sizes"):
        create_mesh((0,), ("sp",), CPU)
    with pytest.raises(ValueError, match="axis names"):
        create_mesh((2, 2), ("sp",), CPU)


def test_sp_apply_refuses_tokens_off_the_mesh_device(sp_pair):
    cfg, params, tokens, _, _, _, _ = sp_pair
    meta_mesh = create_mesh((4,), ("sp",), torch.device("meta"))
    with pytest.raises(ValueError, match="mesh on meta"):
        psp.sp_apply(cfg, params, torch.from_numpy(tokens), meta_mesh)
