"""The port's CUDA flash-attention kernels against their plain versions, on
the card.  Skips without a CUDA device (decided inside the fixture).  On a
machine with the card and without JAX, run it without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_cuda.py

Tolerances as chip_smoke.py states them: fp32 forward atol 2e-5 + rtol 1e-5,
gradients atol 1e-4 + rtol 1e-4 (sums in another order); bf16 outputs and
gradients atol 2e-2 + rtol 3e-2 (bf16 rounding of O, P and dS).
"""

import pytest
import torch

from fedml_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,D,causal,L", [
    (torch.float32, 32, True, 80), (torch.float32, 32, False, 50),
    (torch.bfloat16, 64, True, 200), (torch.float32, 64, True, 130),
])
def test_kernels_match_plain(cuda, dtype, D, causal, L):
    fwd_tol, grad_tol = ((2e-5, 1e-5), (1e-4, 1e-4)) if dtype == torch.float32 else \
        ((2e-2, 3e-2), (2e-2, 3e-2))
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = (torch.randn(3, L, 3, 4, D, generator=gen, device=cuda) * 0.5).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = (torch.randn(3, L, 4, D, generator=gen, device=cuda) * 0.5).to(dtype)
    o, lse = fa.flash_forward_cuda(q, k, v, causal)
    o_ref, lse_ref = fa.flash_forward_plain(q, k, v, causal)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=fwd_tol[0], rtol=fwd_tol[1])
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    delta = (do.float() * o_ref.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse_ref, delta, causal)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta, causal)
    dq_r = fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)
    dk_r, dv_r = fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)
    for got, want in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        torch.testing.assert_close(got.float(), want.float(), atol=grad_tol[0], rtol=grad_tol[1])


def test_autograd_function_launches_all_three_kernels(cuda):
    q, k, v = (torch.randn(2, 40, 2, 32, device=cuda, requires_grad=True) for _ in range(3))
    before = dict(fa.LAUNCHES)
    fa.attention(q, k, v).square().sum().backward()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


def test_unsupported_head_dim_raises(cuda):
    q = torch.zeros(1, 8, 1, 16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_forward_cuda(q, q, q, True)
