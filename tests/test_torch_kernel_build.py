"""Host-side pieces of the port's CUDA kernels that run without a card: the
TMA layout checks of the bf16 tensor-core kernels' wrappers, and the reading
of ptxas's register and spill report that chip_smoke.py holds K1 and K3 to.
"""

import os

import pytest
import torch

from fedml_tpu_torch.ops import build
from fedml_tpu_torch.ops import flash_attention as fa


@pytest.mark.parametrize("shape,make,want", [
    # contiguous [B, L, H, D]
    ((2, 5, 3, 64), lambda t: t, (5 * 3 * 64, 3 * 64, 64)),
    # q of a fused [B, L, 3, H, D] projection
    ((2, 5, 3, 64), lambda t: t.new_zeros(2, 5, 3, 3, 64)[:, :, 0], (5 * 9 * 64, 9 * 64, 64)),
    # size-1 dims take the dense stride, whatever torch reports for them
    ((1, 1, 1, 32), lambda t: t.new_zeros(4, 7, 5, 32)[:1, 2:3, 1:2], (32, 32, 32)),
    ((1, 6, 1, 32), lambda t: t.new_zeros(3, 6, 2, 32)[1:2, :, :1], (6 * 64, 64, 32)),
])
def test_tma_strides_of_views(shape, make, want):
    t = make(torch.zeros(shape, dtype=torch.bfloat16))
    assert tuple(t.shape) == shape
    assert fa.tma_strides(t) == want


def test_tma_check_takes_fused_views_and_refuses_misaligned_ones():
    qkv = torch.zeros(2, 9, 3, 4, 32, dtype=torch.bfloat16)
    fa._check_tma("t", qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    odd_head_stride = torch.zeros(2, 9, 4, 33, dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="TMA"):
        fa._check_tma("t", odd_head_stride)
    flat = torch.zeros(2 * 9 * 4 * 32 + 1, dtype=torch.bfloat16)
    odd_base = flat[1:].view(2, 9, 4, 32)
    if flat.data_ptr() % 16 == 0:  # the allocator's alignment makes flat[1:] 2 bytes off
        with pytest.raises(ValueError, match="TMA"):
            fa._check_tma("t", odd_base)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wrapper", ["flash_forward_cuda", "flash_bwd_dq_cuda",
                                     "flash_bwd_dkv_cuda", "flash_shard_update_cuda"])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper, dtype):
    q = torch.zeros(1, 8, 1, 32, dtype=dtype)
    lse = torch.zeros(1, 1, 8)
    pos = torch.arange(8, dtype=torch.int32)
    args = {"flash_forward_cuda": (q, q, q), "flash_bwd_dq_cuda": (q, q, q, q, lse, lse),
            "flash_bwd_dkv_cuda": (q, q, q, q, lse, lse),
            "flash_shard_update_cuda": (q, q, q, pos, pos, lse, lse, q.float())}[wrapper]
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(fa, wrapper)(*args, True)


def test_pair_check_refuses_odd_fold_state():
    """The bf16 fold moves its fp32 state two floats at a time: an odd head
    stride or a base off an 8-byte boundary raises; fused and size-1 views
    pass."""
    fa._check_pairs("t", torch.zeros(2, 9, 4, 32))
    fa._check_pairs("t", torch.zeros(1, 9, 1, 32))
    with pytest.raises(ValueError, match="two floats"):
        fa._check_pairs("t", torch.zeros(2, 9, 4, 33)[..., :32])
    flat = torch.zeros(2 * 9 * 4 * 32 + 1)
    if flat.data_ptr() % 8 == 0:  # the allocator's alignment makes flat[1:] 4 bytes off
        with pytest.raises(ValueError, match="two floats"):
            fa._check_pairs("t", flat[1:].view(2, 9, 4, 32))


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5flash4sm9021flash_fwd_sm90_kernelILi64EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16PfiiNS_7StridesEif' for 'sm_90a'
ptxas info    : Function properties for _ZN5flash4sm9021flash_fwd_sm90_kernelILi64EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16PfiiNS_7StridesEif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 1024 bytes smem, 568 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5flash20flash_bwd_dkv_kernelILi64EEEvPKfS2_S2_S2_S2_S2_PfS3_iiNS_7StridesES4_S4_S4_S4_S4_if' for 'sm_90a'
ptxas info    : Function properties for _ZN5flash20flash_bwd_dkv_kernelILi64EEEvPKfS2_S2_S2_S2_S2_PfS3_iiNS_7StridesES4_S4_S4_S4_S4_if
    624 bytes stack frame, 660 bytes spill stores, 640 bytes spill loads
ptxas info    : Used 255 registers, 34432 bytes smem, 532 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5flash19flash_bwd_dq_kernelI13__nv_bfloat16Li32EEEvPKT_S4_S4_S4_PKfS6_PS2_iiNS_7StridesES8_S8_S8_S8_if' for 'sm_90a'
ptxas info    : Function properties for _ZN5flash19flash_bwd_dq_kernelI13__nv_bfloat16Li32EEEvPKT_S4_S4_S4_PKfS6_PS2_iiNS_7StridesES8_S8_S8_S8_if
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, 25088 bytes smem, 524 bytes cmem[0]
"""


def test_ptxas_usage_reads_registers_stack_and_spills():
    usage = {build.kernel_label(name): u for name, u in build.ptxas_usage(PTXAS_LOG).items()}
    assert usage == {
        "flash_fwd_sm90_kernel<bf16, 64>": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                                            "registers": 128},
        "flash_bwd_dkv_kernel<fp32, 64>": {"stack": 624, "spill_stores": 660,
                                           "spill_loads": 640, "registers": 255},
        "flash_bwd_dq_kernel<bf16, 32>": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                                          "registers": 96},
    }


def test_every_kernel_source_is_built_and_bound():
    sources = {src for src, _ in build._SIGNATURES.values()}
    assert sources == set(build.SOURCES)
    on_disk = {n for n in os.listdir(build.CSRC) if n.endswith(".cu")}
    assert on_disk == set(build.SOURCES)
