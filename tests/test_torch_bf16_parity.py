"""The port's plain versions against the JAX package's Pallas kernels in bf16.

On the card each bf16 kernel (``flash_fwd_sm90``, ``flash_dq_sm90``,
``flash_dkv_sm90``, ``flash_update_sm90``) is held to its plain version, so the
plain version must itself compute what the Pallas kernel computes in bf16:
the same places where a value is rounded to bf16 (P before P.V, dS before
dS.K and dS^T.Q, the outputs), the same fp32 sums.  Here the same seeded
numpy inputs, rounded to bf16, go through the Pallas kernels in interpret
mode with blocks of 16 and through the plain versions on the CPU.

Tolerances:

* gradients of ``flash_attention`` (dQ, dK, dV, in bf16): atol 1e-3.  The
  two sides sum in another order and round the results to bf16.  Here dQ
  and dK stay below 0.25, where one bf16 step is at most 2^-10 (9.8e-4), the
  largest difference they show; dV, up to 1.6, comes out equal.
* the shard fold (fp32 state): m atol 1e-5 + rtol 1e-6, l atol 1e-5 + rtol
  1e-5, and the unnormalised o within 3e-3 * max(l, 1) + 1e-2 * |o|, the
  fold tolerance of chip_smoke.py.  The Pallas fold rounds P against the
  running max of its 16-key block, the plain one against the shard's max, so
  P may sit one bf16 step apart.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.flash_attention import flash_attention as jax_flash
from fedml_tpu.ops.flash_attention import flash_shard_update as jax_fold
from fedml_tpu_torch.ops import flash_attention as fa


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BF16 = torch.bfloat16


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 and widened back, so both sides start from the same
    bf16 values."""
    return torch.from_numpy(a).to(BF16).float().numpy()


def _to_jax(a: np.ndarray):
    return jnp.asarray(a, dtype=jnp.bfloat16)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(BF16)


# (B, L, H, D, causal): a ragged L against the blocks of 16
GRAD_CASES = {
    "causal_L40": (1, 40, 2, 16, True),
    "full_L40": (1, 40, 2, 16, False),
    "causal_L48_B2": (2, 48, 1, 16, True),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_bf16_gradients_match_pallas(case):
    B, L, H, D, causal = GRAD_CASES[case]
    rs = np.random.RandomState(sorted(GRAD_CASES).index(case))
    q, k, v, w = (_bf16(rs.randn(B, L, H, D).astype(np.float32) * 0.5) for _ in range(4))

    def loss_j(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal, 16, 16, True).astype(jnp.float32) * w)

    # jitted as a whole: bit for bit the eager interpreter's gradients here
    grads_j = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(_to_jax(q), _to_jax(k), _to_jax(v))
    qt, kt, vt = (_to_torch(a).requires_grad_() for a in (q, k, v))
    (fa.flash_attention(qt, kt, vt, causal).float() * torch.from_numpy(w)).sum().backward()
    for name, gt, gj in zip("qkv", (qt.grad, kt.grad, vt.grad), grads_j):
        assert gt.dtype == BF16 and gj.dtype == jnp.bfloat16
        np.testing.assert_allclose(gt.float().numpy(), np.asarray(gj, dtype=np.float32),
                                   atol=1e-3, err_msg=f"d{name}")


B, H, D = 2, 2, 16
# name: (Lq, Lk, q offset, k offset, padded key tail, carried state).  Causal
# folds of one q shard: keys all before the rows, the rows' own shard (the
# diagonal, the ring's first fold, from the empty state), and a ragged shard
# with a padded tail that straddles the rows.
FOLDS = {
    "past": (32, 32, 32, 0, 0, True),
    "diagonal": (32, 32, 32, 32, 0, False),
    "padded_tail": (24, 40, 32, 16, 7, True),
}


@pytest.mark.parametrize("name", sorted(FOLDS))
def test_bf16_fold_matches_pallas(name):
    Lq, Lk, q_off, k_off, tail, carried = FOLDS[name]
    rs = np.random.RandomState(10 + sorted(FOLDS).index(name))
    q = _bf16(rs.randn(B, Lq, H, D).astype(np.float32) * 0.5)
    k, v = (_bf16(rs.randn(B, Lk, H, D).astype(np.float32) * 0.5) for _ in range(2))
    q_pos = (q_off + np.arange(Lq)).astype(np.int32)
    k_pos = (k_off + np.arange(Lk)).astype(np.int32)
    if tail:
        k_pos[-tail:] = -1
    state = (torch.full((B, H, Lq), float("-inf")), torch.zeros(B, H, Lq),
             torch.zeros(B, Lq, H, D))
    if carried:  # the state after the rows' own shard, as a ring leaves it
        state = fa.flash_shard_update_plain(_to_torch(q), _to_torch(q), _to_torch(q),
                                            torch.from_numpy(q_pos), torch.from_numpy(q_pos),
                                            *state, True)
    m, l, o = (t.numpy() for t in state)
    fold = jax.jit(partial(jax_fold, causal=True, block_q=16, block_k=16, interpret=True))
    want = [np.asarray(x) for x in fold(_to_jax(q), _to_jax(k), _to_jax(v), jnp.asarray(q_pos),
                                        jnp.asarray(k_pos), jnp.asarray(m), jnp.asarray(l),
                                        jnp.asarray(o))]
    got = [t.numpy() for t in fa.flash_shard_update_plain(
        _to_torch(q), _to_torch(k), _to_torch(v), torch.from_numpy(q_pos),
        torch.from_numpy(k_pos), torch.from_numpy(m), torch.from_numpy(l),
        torch.from_numpy(o), True)]
    assert all(g.dtype == np.float32 for g in got)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-6, err_msg="m")
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-5, err_msg="l")
    scale = np.maximum(want[1], 1.0).transpose(0, 2, 1)[..., None]
    err = np.abs(got[2] - want[2])
    assert (err <= 3e-3 * scale + 1e-2 * np.abs(want[2])).all(), \
        f"o differs by {err.max():.3e} ({(err / scale).max():.3e} over max(l, 1))"
