"""The port's TransformerLM against the JAX package's, weights carried across.

The flax init is transplanted with ``fedml_tpu_torch.models.convert``; the JAX
logits come through the Pallas flash kernel in interpret mode and the
gradients through its oracle ``reference_attention`` (the Pallas gradients
are held to the port's in test_torch_flash_attention.py); the port attends
through its kernels' plain versions (CPU tensors).  Logits are held to atol
3e-4, the tolerance tests/test_long_context.py uses for this comparison;
gradients of the LM loss, for every parameter, to atol 2e-5 + rtol 1e-4
(fp32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ml.engine.train import softmax_ce_loss as jax_ce
from fedml_tpu.models.transformer import TransformerConfig as JCfg, TransformerLM as JLM
from fedml_tpu.ops.flash_attention import flash_attention as jax_flash
from fedml_tpu_torch.ml.engine.train import softmax_ce_loss
from fedml_tpu_torch.models import convert
from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM, rope


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64)


def _jax_attn(q, k, v):
    return jax_flash(q, k, v, True, 16, 16, True)


@pytest.fixture(scope="module")
def pair():
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, CFG["vocab_size"], size=(2, 32)).astype(np.int32)
    labels = rs.randint(0, CFG["vocab_size"], size=(2, 32)).astype(np.int32)
    jmodel = JLM(JCfg(**CFG))  # attention: reference_attention on the CPU
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(tokens))
    tmodel = TransformerLM(TransformerConfig(**CFG))
    tvars = convert.variables_from_flax(jax.tree_util.tree_map(np.asarray, variables),
                                        tmodel, torch.device("cpu"))
    with torch.no_grad():
        for name, p in tmodel.named_parameters():
            p.copy_(tvars[name])
    return jmodel, variables, tmodel, tokens, labels


def test_logits_match(pair):
    jmodel, variables, tmodel, tokens, _ = pair
    flash = JLM(JCfg(**CFG), attention_fn=_jax_attn)
    ref = np.asarray(jax.jit(flash.apply)(variables, jnp.asarray(tokens)))
    out = tmodel(torch.from_numpy(tokens)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=3e-4)


def test_loss_gradients_match_for_every_parameter(pair):
    jmodel, variables, tmodel, tokens, labels = pair
    mask = np.array([1.0, 0.0], np.float32)  # the second example is padding

    def loss_j(params):
        logits = jmodel.apply({"params": params}, jnp.asarray(tokens))
        return jax_ce(logits, jnp.asarray(labels), jnp.asarray(mask))[0]

    lj, gj = jax.jit(jax.value_and_grad(loss_j))(variables["params"])
    gj = convert.transformer_state_from_flax(jax.tree_util.tree_map(np.asarray, gj))
    tmodel.zero_grad()
    lt = softmax_ce_loss(tmodel(torch.from_numpy(tokens)), torch.from_numpy(labels),
                         torch.from_numpy(mask))[0]
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    names = [n for n, _ in tmodel.named_parameters()]
    assert sorted(names) == sorted(gj)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gj[name], atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_rope_matches_jax():
    from fedml_tpu.models.transformer import rope as jax_rope

    rs = np.random.RandomState(1)
    x = rs.randn(2, 12, 2, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    np.testing.assert_allclose(rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
                               np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos))),
                               atol=1e-6)


def test_convert_rejects_a_misshapen_tree(pair):
    _, variables, _, _, _ = pair
    tree = jax.tree_util.tree_map(np.asarray, variables)
    tree["params"]["layer1"]["wi_gate"]["kernel"] = np.zeros((32, 32), np.float32)
    tmodel = TransformerLM(TransformerConfig(**CFG), device="meta")
    with pytest.raises(ValueError, match="wi_gate"):
        convert.variables_from_flax(tree, tmodel, torch.device("cpu"))
