"""The numerical design of the fp32 kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``, over ``csrc/flash_tf32.cuh``), emulated on the CPU:
products on TF32 tensor cores, each fp32 operand split into a big and a small
TF32 part, three products summed in fp32.

TF32 keeps 10 of fp32's 23 mantissa bits.  ``tf32`` drops the low 13 bits
of the int32 view, rounding to nearest with ties away from zero (the
rounding of ``cvt.rna.tf32.f32``, which the kernel does as an integer add and
mask), to nearest even, or by truncation (what the tensor cores do to the
low bits of an operand: the kernel passes small = x - big as it is).  Either
way the split x = big + small keeps about 21 bits, and small . small, the one
dropped term, is 2^-22 of the product.  Attention at
B 2, L 80, H 2, D 32 with the scores Q.K^T and O = P.V so computed must hold
a float64 ``reference_attention`` to the fp32 forward tolerance the card
holds the kernel to (O atol 2e-5 + rtol 1e-5, LSE atol 1e-5 + rtol 1e-6);
the same with one TF32 product (big . big) must fail it.  So must the
backward's dQ, dK and dV, with S, dP, P^T.dO, dS.K and dS^T.Q so computed,
to the gradient tolerance (atol 1e-4 + rtol 1e-4), and one TF32 product must
fail it on dV.  That is why the kernels take three products and what planted
single-TF32 copies of them show on the card (tests/test_torch_flash_cuda.py).
"""

import math

import numpy as np
import pytest
import torch

from fedml_tpu_torch.ops import flash_attention as fa

O_TOL = (2e-5, 1e-5)
LSE_TOL = (1e-5, 1e-6)
GRAD_TOL = (1e-4, 1e-4)


def tf32(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """fp32 -> a TF32 value (10 mantissa bits), as fp32: the nearest, ties
    away from zero ("rna") or to even ("rne"), or truncated ("trunc")."""
    i = x.view(torch.int32)
    if rounding == "rna":  # the magnitude is rounded up at the half
        i = (i + 0x1000) & ~0x1FFF
    elif rounding == "rne":
        i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    else:
        i = i & ~0x1FFF
    return i.view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, split: bool, rounding) -> torch.Tensor:
    """a @ b with fp32 sums of TF32 products: big . big alone, or the kernel's
    small . big + big . small, then big . big; ``rounding`` is that of big
    and of small."""
    big_r, small_r = rounding
    a_big, b_big = tf32(a, big_r), tf32(b, big_r)
    out = a_big @ b_big
    if split:
        a_small, b_small = tf32(a - a_big, small_r), tf32(b - b_big, small_r)
        out = (a_small @ b_big + a_big @ b_small) + out
    return out


def tf32_attention(q, k, v, causal: bool, split: bool, rounding: str):
    """(O, LSE) of [B, L, H, D] fp32 inputs, the products as the kernel takes
    them and the softmax in fp32."""
    L, D = q.shape[1], q.shape[-1]
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # [B, H, L, D]
    s = tf32_matmul(qh, kh.transpose(-1, -2), split, rounding) * (1.0 / math.sqrt(D))
    if causal:
        s = s.masked_fill(~torch.ones(L, L, dtype=torch.bool).tril(), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = tf32_matmul(p, vh, split, rounding) / l
    return o.permute(0, 2, 1, 3), (m + torch.log(l)).squeeze(-1)


def tf32_attention_grads(q, k, v, do, lse, delta, causal: bool, split: bool, rounding: str):
    """(dQ, dK, dV) of [B, L, H, D] fp32 inputs, the backward kernels' way: P
    rebuilt from the given LSE [B, H, L], dS = P * (dP - delta) * scale, the
    five products as the kernels take them, the rest in fp32."""
    L, D = q.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qh, kh, vh, doh = (t.permute(0, 2, 1, 3) for t in (q, k, v, do))  # [B, H, L, D]
    s = tf32_matmul(qh, kh.transpose(-1, -2), split, rounding) * scale
    dp = tf32_matmul(doh, vh.transpose(-1, -2), split, rounding)
    live = torch.ones(L, L, dtype=torch.bool)
    if causal:
        live = live.tril()
    p = torch.where(live, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    ds = p * (dp - delta[..., None]) * scale
    dq = tf32_matmul(ds, kh, split, rounding)
    dk = tf32_matmul(ds.transpose(-1, -2), qh, split, rounding)
    dv = tf32_matmul(p.transpose(-1, -2), doh, split, rounding)
    return tuple(t.permute(0, 2, 1, 3) for t in (dq, dk, dv))


def _within(got, want, tol) -> bool:
    return bool(((got.double() - want).abs() <= tol[0] + tol[1] * want.abs()).all())


@pytest.mark.parametrize("rounding", ["rna", "rne"])
def test_tf32_rounding_keeps_ten_mantissa_bits(rounding):
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
    big = tf32(x, rounding)
    assert bool((big.view(torch.int32) & 0x1FFF == 0).all())
    assert float(((x - big).abs() / x.abs()).max()) <= 2.0 ** -11
    small = tf32(x - big, rounding)
    assert float(((x - big - small).abs() / x.abs()).max()) <= 2.0 ** -21


@pytest.fixture(scope="module")
def case():
    """Inputs at B 2, L 80, H 2, D 32 and the float64 reference (O, LSE)."""
    rs = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rs.randn(2, 80, 2, 32).astype(np.float32) * 0.5)
               for _ in range(3))
    o_ref = fa.reference_attention(q.double(), k.double(), v.double(), True)
    s_ref = torch.einsum("blhd,bmhd->bhlm", q.double(), k.double()) / math.sqrt(32)
    s_ref = s_ref.masked_fill(~torch.ones(80, 80, dtype=torch.bool).tril(), float("-inf"))
    return (q, k, v), o_ref, torch.logsumexp(s_ref, dim=-1)


# (big, small): the kernel's (big rounded to nearest, ties away, by an integer
# add; small's low bits dropped by the tensor cores), and both to nearest
@pytest.mark.parametrize("rounding", [("rna", "trunc"), ("rna", "rna"), ("rne", "rne")],
                         ids=["kernel", "rna", "rne"])
@pytest.mark.parametrize("split", [True, False], ids=["split_tf32", "single_tf32"])
def test_split_tf32_attention_holds_the_fp32_tolerance(case, split, rounding):
    qkv, o_ref, lse_ref = case
    o, lse = tf32_attention(*qkv, True, split, rounding)
    if split:
        assert _within(o, o_ref, O_TOL)
        assert _within(lse, lse_ref, LSE_TOL)
    else:
        assert not _within(o, o_ref, O_TOL)


@pytest.fixture(scope="module")
def grad_case(case):
    """dO, the LSE and delta in fp32 (as the forward hands them to the
    backward), and the float64 reference gradients of the same inputs."""
    (q, k, v), o_ref, lse_ref = case
    do = torch.from_numpy(np.random.RandomState(6).randn(*q.shape).astype(np.float32) * 0.5)
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    o = fa.reference_attention(q64, k64, v64, True)
    grads = torch.autograd.grad(o, (q64, k64, v64), do.double())
    delta = (do.double() * o_ref).sum(-1).permute(0, 2, 1)
    return (q, k, v, do, lse_ref.float(), delta.float()), grads


@pytest.mark.parametrize("rounding", [("rna", "trunc"), ("rna", "rna"), ("rne", "rne")],
                         ids=["kernel", "rna", "rne"])
@pytest.mark.parametrize("split", [True, False], ids=["split_tf32", "single_tf32"])
def test_split_tf32_backward_holds_the_fp32_grad_tolerance(grad_case, split, rounding):
    inputs, (dq_ref, dk_ref, dv_ref) = grad_case
    dq, dk, dv = tf32_attention_grads(*inputs, True, split, rounding)
    if split:
        for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
            assert _within(got, want, GRAD_TOL)
    else:
        assert not _within(dv, dv_ref, GRAD_TOL)
