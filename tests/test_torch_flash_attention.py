"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU the port runs the plain versions of its CUDA kernels (the
autograd Function routes CPU tensors there); the JAX side runs the Pallas
kernels in interpret mode, as tests/test_long_context.py does, each call
jitted as a whole (one program, where the eager interpreter compiles the
kernel body op by op: 2.6-2.9 s a gradient eagerly, 1.0-1.4 s jitted, the
two within 1e-7).  The same numpy inputs feed both.  Tolerances are the repo's own for these kernels:
atol 2e-5 for forward values, 1e-4 for gradients (fp32; the two sides sum in
different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.flash_attention import _flash_forward, flash_attention as jax_flash
from fedml_tpu_torch.ops import flash_attention as port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (B, L, H, D, causal, block_q, block_k): causal and full, ragged L with
# blocks of 16, the mismatched blocks of test_mismatched_block_sizes, and
# the seq2seq decoder's call
CASES = {
    "causal_L32": (1, 32, 2, 8, True, 16, 16),
    "full_L32": (1, 32, 2, 8, False, 16, 16),
    "ragged_causal_L50": (2, 50, 2, 8, True, 16, 16),
    "ragged_full_L50": (2, 50, 2, 8, False, 16, 16),
    "mismatched_32_24": (1, 32, 1, 8, False, 32, 24),
    "mismatched_24_32": (1, 32, 1, 8, False, 24, 32),
    # the seq2seq decoder's shape (L 24, 4 heads x 32) under one 128-row tile
    "s2s_causal_L24": (2, 24, 4, 32, True, 128, 128),
}


def _inputs(B, L, H, D, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v, w = (rs.randn(B, L, H, D).astype(np.float32) * 0.5 for _ in range(4))
    return q, k, v, w


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_lse_match_pallas(case):
    B, L, H, D, causal, bq, bk = CASES[case]
    q, k, v, _ = _inputs(B, L, H, D, seed=1)
    o_j, lse_j = jax.jit(lambda q, k, v: _flash_forward(q, k, v, causal, bq, bk, True,
                                                         with_lse=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o_t, lse_t = port.flash_forward(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-5)
    # JAX keeps LSE as [B*H, Lp] over the padded length; the port as [B, H, L]
    lse_j = np.asarray(lse_j)[:, :L].reshape(B, H, L)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=2e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_pallas(case):
    B, L, H, D, causal, bq, bk = CASES[case]
    q, k, v, w = _inputs(B, L, H, D, seed=2)

    def loss_j(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal, bq, bk, True) * w)

    grads_j = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k),
                                                          jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (port.flash_attention(qt, kt, vt, causal) * torch.from_numpy(w)).sum().backward()
    for name, gt, gj in zip("qkv", (qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_port_reference(causal):
    """The plain kernel twin agrees with the port's fused-softmax oracle."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(2, 24, 2, 8, seed=3))
    o, _ = port.flash_forward_plain(q, k, v, causal)
    np.testing.assert_allclose(o.numpy(), port.reference_attention(q, k, v, causal).numpy(),
                               atol=2e-5)


def test_plain_bf16_rounds_like_the_kernel_contract():
    """In bf16 the plain versions keep the kernel dtype contract: outputs in
    bf16, LSE in fp32, and values within bf16 resolution (2^-8 relative) of
    the fp32 result."""
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(1, 40, 2, 32, seed=4))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    o_b, lse_b = port.flash_forward_plain(qb, kb, vb, True)
    o_f, lse_f = port.flash_forward_plain(qb.float(), kb.float(), vb.float(), True)
    assert o_b.dtype == torch.bfloat16 and lse_b.dtype == torch.float32
    np.testing.assert_allclose(lse_b.numpy(), lse_f.numpy(), atol=1e-5)
    np.testing.assert_allclose(o_b.float().numpy(), o_f.numpy(), atol=2e-2)
    do = w.to(torch.bfloat16)
    delta = (do.float() * o_b.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq = port.flash_bwd_dq_plain(qb, kb, vb, do, lse_b, delta, True)
    dk, dv = port.flash_bwd_dkv_plain(qb, kb, vb, do, lse_b, delta, True)
    assert {dq.dtype, dk.dtype, dv.dtype} == {torch.bfloat16}
