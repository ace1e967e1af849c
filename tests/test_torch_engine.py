"""The port's local-training engine against the JAX package's.

Same numpy inputs on both sides.  Tolerances (fp32, sums in other orders):
loss values rtol 1e-6; one or two optimizer steps atol 1e-6; a whole local
run of a small TransformerLM atol 2e-5 on every parameter.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.ml.engine import train as jtrain
from fedml_tpu.models.transformer import TransformerConfig as JCfg, TransformerLM as JLM
from fedml_tpu_torch.ml.engine import train as ttrain
from fedml_tpu_torch.models import convert
from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(**kw):
    base = dict(client_optimizer="sgd", learning_rate=0.1, weight_decay=0.0, momentum=0.0,
                epochs=1)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_softmax_ce_loss_on_token_labels():
    rs = np.random.RandomState(0)
    logits = rs.randn(3, 7, 11).astype(np.float32)
    labels = rs.randint(0, 11, size=(3, 7)).astype(np.int32)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    lj, (tj, cj) = jtrain.softmax_ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                                          jnp.asarray(mask))
    lt, (tt, ct) = ttrain.softmax_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                          torch.from_numpy(mask))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    np.testing.assert_allclose(float(tt), float(tj), rtol=1e-6)
    assert float(ct) == float(cj) == 14.0


OPTIMIZERS = {
    "sgd": dict(client_optimizer="sgd"),
    "sgd_momentum": dict(client_optimizer="sgd", momentum=0.9),
    "sgd_weight_decay": dict(client_optimizer="sgd", momentum=0.9, weight_decay=0.01),
    "adam": dict(client_optimizer="adam", learning_rate=0.01),
    "adam_weight_decay": dict(client_optimizer="adam", learning_rate=0.01, weight_decay=0.01),
    "adamw": dict(client_optimizer="adamw", learning_rate=0.01, weight_decay=0.05),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_optax(name):
    """Two steps, so momentum and moment state carry between them."""
    args = _args(**OPTIMIZERS[name])
    rs = np.random.RandomState(1)
    p0 = rs.randn(5, 4).astype(np.float32)
    grads = [rs.randn(5, 4).astype(np.float32) for _ in range(2)]
    tx = jtrain.make_optimizer(args)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = ttrain.make_optimizer(args)([pt])
    for g in grads:
        pt.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), atol=1e-6)


CFG = dict(vocab_size=40, d_model=16, n_heads=2, n_layers=1, d_ff=32)


@pytest.fixture(scope="module")
def lm_pair():
    rs = np.random.RandomState(2)
    x = rs.randint(0, CFG["vocab_size"], size=(16, 12)).astype(np.int32)
    y = rs.randint(0, CFG["vocab_size"], size=(16, 12)).astype(np.int32)
    jmodel = JLM(JCfg(**CFG))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.asarray(x[:1]))
    tmodel = TransformerLM(TransformerConfig(**CFG))
    tvars = convert.variables_from_flax(jax.tree_util.tree_map(np.asarray, variables),
                                        tmodel, torch.device("cpu"))
    return jmodel, variables, tmodel, tvars, x, y


def test_local_train_matches_jax_engine(lm_pair):
    """batch_size >= padded_n: one full batch per epoch, so the two engines'
    different shuffles cannot change the result; 10 of 16 rows are valid."""
    jmodel, variables, tmodel, tvars, x, y = lm_pair
    args = _args(client_optimizer="sgd", learning_rate=0.5, epochs=3)
    jfn = jax.jit(jtrain.build_local_train(jmodel, args, batch_size=16, padded_n=16))
    jres = jfn(variables, jnp.asarray(x), jnp.asarray(y), 10, jax.random.PRNGKey(0))
    tfn = ttrain.build_local_train(tmodel, args, batch_size=16, padded_n=16)
    tres = tfn(tvars, torch.from_numpy(x), torch.from_numpy(y), 10, seed=(0,))
    np.testing.assert_allclose(float(tres.loss), float(jres.loss), rtol=1e-5)
    assert tres.seen == float(jres.seen) == 30.0
    assert tres.steps == float(jres.steps) == 3.0
    want = convert.transformer_state_from_flax(
        jax.tree_util.tree_map(np.asarray, jres.variables))
    for name, v in tres.variables.items():
        np.testing.assert_allclose(v.numpy(), want[name], atol=2e-5, err_msg=name)


def test_empty_client_leaves_params_and_adam_state_untouched(lm_pair):
    _, _, tmodel, tvars, x, y = lm_pair
    args = _args(client_optimizer="adam", learning_rate=0.01, epochs=2)
    fn = ttrain.build_local_train(tmodel, args, batch_size=4, padded_n=16)
    res = fn(tvars, torch.from_numpy(x), torch.from_numpy(y), 0, seed=(1,))
    assert res.steps == 0.0 and res.seen == 0.0 and float(res.loss) == 0.0
    assert res.opt_state == {}  # Adam never stepped: no moments, no step count
    for name, v in res.variables.items():
        assert torch.equal(v, tvars[name]), name


def test_all_padding_batches_take_no_adam_step(lm_pair):
    """3 valid rows of 16 in batches of 4: only the batches that hold a valid
    row step, and Adam's step count says exactly how many did."""
    _, _, tmodel, tvars, x, y = lm_pair
    args = _args(client_optimizer="adam", learning_rate=0.01, epochs=2)
    fn = ttrain.build_local_train(tmodel, args, batch_size=4, padded_n=16)
    res = fn(tvars, torch.from_numpy(x), torch.from_numpy(y), 3, seed=(2,))
    assert 2.0 <= res.steps < 8.0 and res.seen == 6.0
    for state in res.opt_state.values():
        assert float(state["step"]) == res.steps


def test_pad_to_repeats_the_last_row():
    x = torch.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(ttrain.pad_to(x, 5).numpy(),
                                  np.asarray(jtrain.pad_to(jnp.arange(6).reshape(3, 2), 5)))
