"""The port's CUDA flash-attention kernels against their plain versions, on
the card.  Skips without a CUDA device (decided inside the fixture).  On a
machine with the card and without JAX, run it without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_cuda.py

In bf16 every kernel is a tensor-core (wgmma, TMA) kernel; the edge cases of
test_kernels_match_plain and test_shard_update_kernel_matches_plain cover
their 64-row tiles.
The fp32 forward, dQ, dK/dV and shard-fold kernels are split-TF32 kernels
(three TF32 products per fp32 product on the tensor cores,
csrc/flash_tf32.cuh); test_fp32_fwd_tolerance_fails_a_planted_fault,
test_fp32_bwd_tolerance_fails_a_planted_fault and
test_fp32_fold_tolerance_fails_a_planted_fault show that one TF32 product
fails their tolerances.
Tolerances as chip_smoke.py states them: fp32 forward atol 2e-5 + rtol 1e-5,
gradients atol 1e-4 + rtol 1e-4 (sums in another order); bf16 O atol 1e-3 +
rtol 2e-2 and gradients atol 1e-3 + rtol 3e-2 (bf16 rounding of O, P and dS;
the atol small against typical values, so that an error confined to some
tiles fails, as a planted one must below).  The shard
fold (K4): m atol 1e-5 + rtol 1e-6 and l atol 1e-5 + rtol 1e-5 in both types
(fp32 on both sides); its unnormalised o, whose rounding error grows with the
row's denominator l, within atol * max(l, 1) + rtol * |o|, with (atol, rtol)
(2e-5, 1e-5) in fp32 and (3e-3, 1e-2) in bf16, chip_smoke.py's fold tolerance
(set there from the errors read on the card).
"""

import shutil
import subprocess

import pytest
import torch

from fedml_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

BF16_TOL = {"o": (1e-3, 2e-2), "grad": (1e-3, 3e-2)}
# the launch counters of K1-K3 by input type
KERNELS = {torch.float32: {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"},
           torch.bfloat16: {"flash_fwd_sm90", "flash_dq_sm90", "flash_dkv_sm90"}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("L", [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 80, 127, 128, 129, 1000])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda, dtype, D, causal, L):
    """K1-K3 against their plain versions over the tile edges (one row; a
    16-row warp tile and 8-key step of the fp32 kernels short of, at and past
    16; the fp32 kernels' 32-row streamed tiles at D 64 short of, at and past
    32; a tile short of, at, and past 64 and 128 rows; the slice's 80; a
    ragged long run), with q, k and v as views of one fused qkv, as the model
    gives them."""
    fwd_tol, grad_tol = ((2e-5, 1e-5), (1e-4, 1e-4)) if dtype == torch.float32 else \
        (BF16_TOL["o"], BF16_TOL["grad"])
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = (torch.randn(3, L, 3, 4, D, generator=gen, device=cuda) * 0.5).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = (torch.randn(3, L, 4, D, generator=gen, device=cuda) * 0.5).to(dtype)
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_forward_cuda(q, k, v, causal)
    o_ref, lse_ref = fa.flash_forward_plain(q, k, v, causal)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=fwd_tol[0], rtol=fwd_tol[1])
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    delta = (do.float() * o_ref.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse_ref, delta, causal)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta, causal)
    kernels = KERNELS[dtype]
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        n: int(n in kernels) for n in before}
    dq_r = fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)
    dk_r, dv_r = fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)
    for got, want in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=grad_tol[0], rtol=grad_tol[1])


def test_bf16_kernels_reject_what_tma_cannot_load(cuda):
    """The bf16 kernels load tiles with TMA: a head stride that is not a whole
    16 bytes, or a base off a 16-byte boundary, raises, and no kernel
    launches (nothing falls back to another kernel)."""
    shape = (2, 70, 2, 64)
    good = torch.randn(shape, device=cuda).to(torch.bfloat16)
    odd_stride = torch.zeros(2, 70, 2, 65, dtype=torch.bfloat16, device=cuda)[..., :64]
    odd_base = torch.zeros(good.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(shape)
    lse = torch.zeros(2, 2, 70, device=cuda)
    pos = torch.arange(70, dtype=torch.int32, device=cuda)
    o = torch.zeros(shape, device=cuda)
    before = dict(fa.LAUNCHES)
    for bad in (odd_stride, odd_base):
        with pytest.raises(ValueError, match="TMA"):
            fa.flash_forward_cuda(bad, good, good, True)
        with pytest.raises(ValueError, match="TMA"):
            fa.flash_bwd_dq_cuda(good, good, good, bad, lse, lse, True)
        with pytest.raises(ValueError, match="TMA"):
            fa.flash_bwd_dkv_cuda(good, good, good, bad, lse, lse, True)
        with pytest.raises(ValueError, match="TMA"):
            fa.flash_shard_update_cuda(good, bad, good, pos, pos, lse, lse, o, True)
    assert fa.LAUNCHES == before


def test_fp32_forward_rejects_what_cp_async_cannot_load(cuda):
    """The fp32 forward loads tiles with 16-byte cp.async copies: a head
    stride that is not a whole 16 bytes, or a base off a 16-byte boundary,
    raises, and no kernel launches; a fused-qkv view (rows of D * 4 bytes)
    loads as it is."""
    shape = (2, 70, 2, 64)
    good = torch.randn(shape, device=cuda)
    odd_stride = torch.zeros(2, 70, 2, 65, device=cuda)[..., :64]
    odd_base = torch.zeros(good.numel() + 1, device=cuda)[1:].view(shape)
    before = dict(fa.LAUNCHES)
    for bad in (odd_stride, odd_base):
        for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
            with pytest.raises(ValueError, match="cp.async"):
                fa.flash_forward_cuda(*args, True)
    assert fa.LAUNCHES == before
    qkv = torch.randn(2, 70, 3, 2, 64, device=cuda)
    fa.flash_forward_cuda(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], True)
    assert fa.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1


def test_fp32_backward_rejects_what_cp_async_cannot_load(cuda):
    """The fp32 dQ and dK/dV kernels load tiles with 16-byte cp.async copies:
    a head stride that is not a whole 16 bytes, or a base off a 16-byte
    boundary, in q, k, v or dO raises, and no kernel launches; fused-qkv
    views load as they are."""
    shape = (2, 70, 2, 64)
    good = torch.randn(shape, device=cuda)
    odd_stride = torch.zeros(2, 70, 2, 65, device=cuda)[..., :64]
    odd_base = torch.zeros(good.numel() + 1, device=cuda)[1:].view(shape)
    lse = torch.zeros(2, 2, 70, device=cuda)
    before = dict(fa.LAUNCHES)
    for bad in (odd_stride, odd_base):
        for i in range(4):
            args = [good] * 4
            args[i] = bad
            with pytest.raises(ValueError, match="cp.async"):
                fa.flash_bwd_dq_cuda(*args, lse, lse, True)
            with pytest.raises(ValueError, match="cp.async"):
                fa.flash_bwd_dkv_cuda(*args, lse, lse, True)
    assert fa.LAUNCHES == before
    qkv = torch.randn(2, 70, 3, 2, 64, device=cuda)
    fa.flash_bwd_dq_cuda(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], good, lse, lse, True)
    fa.flash_bwd_dkv_cuda(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], good, lse, lse, True)
    assert fa.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert fa.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1


def _least_atol(got, want, rtol):
    """The least atol with which |got - want| <= atol + rtol * |want| holds."""
    err = (got.float() - want.float()).abs() - rtol * want.float().abs()
    return err.clamp_min(0.0).max().item()


# a planted fault in the bf16 dK/dV kernel: past the first key tile and the
# first q tile of its loop, dK's product reads Q from the ring's other stage
SOUND_DK = "wgmma_rs<D>(dk_acc, df[kk], k_step_mnmajor<D>(desc_mnmajor<D>(q_addr), kk));"
FAULT_DK = ("wgmma_rs<D>(dk_acc, df[kk], k_step_mnmajor<D>(desc_mnmajor<D>(\n"
            "    kt >= 1 && it >= 1 ? base_u + S::Q + (stage ^ 1) * S::TILE : q_addr), kk));")
# in the fp32 forward: the two correction products of split TF32 removed,
# which leaves one TF32 product (big . big) for each fp32 product
SOUND_FWD = ("  mma_tf32(d, a_small, b_big0, b_big1);\n"
             "  mma_tf32(d, a_big, b_small0, b_small1);\n")
FAULT_FWD = ""
# and in the bf16 dQ kernel: past the first key tile, dS.K reads K from the
# ring's other stage
SOUND_DQ = "wgmma_rs<D>(dq_acc, df[kk], k_step_mnmajor<D>(desc_mnmajor<D>(k_addr), kk));"
FAULT_DQ = ("wgmma_rs<D>(dq_acc, df[kk], k_step_mnmajor<D>(desc_mnmajor<D>(\n"
            "    kt >= 1 ? base_u + S::K + (stage ^ 1) * S::TILE : k_addr), kk));")


def test_fp32_fwd_tolerance_fails_a_planted_fault(cuda, tmp_path, monkeypatch):
    """At the slice's shape (B 32, L 80, H 8, D 32, causal; the inputs of
    chip_smoke.py's slice_train case) the fp32 O tolerance (atol 2e-5 +
    rtol 1e-5) passes the split-TF32 forward and fails a copy of it that
    takes one TF32 product per fp32 product (the two correction products
    removed).  Prints the least atol each needs."""
    gen = torch.Generator(device=cuda).manual_seed(1234)
    qkv = torch.randn(32, 80, 3, 8, 32, generator=gen, device=cuda) * 0.5
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o_r, lse_r = fa.flash_forward_plain(q, k, v, True)
    atol, rtol = 2e-5, 1e-5
    o, lse = fa.flash_forward_cuda(q, k, v, True)
    sound = _least_atol(o, o_r, rtol)

    _plant_fault(monkeypatch, tmp_path, "flash_fwd.cu", SOUND_FWD, FAULT_FWD,
                 edit="flash_tf32.cuh")
    o_f, _ = fa.flash_forward_cuda(q, k, v, True)
    torch.cuda.synchronize()
    fault = _least_atol(o_f, o_r, rtol)
    print(f"\nfp32 forward at the slice shape: least atol at rtol {rtol}: split TF32 "
          f"{sound:.3e}, one TF32 product {fault:.3e}")
    assert sound <= atol
    torch.testing.assert_close(lse, lse_r, atol=1e-5, rtol=1e-6)
    assert fault > atol


def test_fp32_bwd_tolerance_fails_a_planted_fault(cuda, tmp_path, monkeypatch):
    """At the slice's shape (the inputs of chip_smoke.py's slice_train case:
    q, k, v views of one fused qkv, dO, the plain forward's LSE and delta)
    the fp32 gradient tolerance (atol 1e-4 + rtol 1e-4) passes the split-TF32
    dQ and dK/dV kernels and fails copies of them that take one TF32 product
    per fp32 product (the two correction products removed from the shared
    split).  The assertion is on the gradient that fails by the most; prints
    the least atol each gradient needs."""
    gen = torch.Generator(device=cuda).manual_seed(1234)
    qkv = torch.randn(32, 80, 3, 8, 32, generator=gen, device=cuda) * 0.5
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(32, 80, 8, 32, generator=gen, device=cuda) * 0.5
    o_r, lse = fa.flash_forward_plain(q, k, v, True)
    delta = (do * o_r).sum(-1).permute(0, 2, 1).contiguous()
    want = (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, True),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True))
    atol, rtol = 1e-4, 1e-4

    def grads():
        got = (fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, True),
               *fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True))
        torch.cuda.synchronize()
        return [_least_atol(g, w, rtol) for g, w in zip(got, want)]

    sound = grads()
    _plant_fault(monkeypatch, tmp_path, "flash_bwd.cu", SOUND_FWD, FAULT_FWD,
                 edit="flash_tf32.cuh")
    fault = grads()
    print(f"\nfp32 backward at the slice shape: least atol at rtol {rtol} (dQ, dK, dV): "
          f"split TF32 {', '.join(f'{x:.3e}' for x in sound)}; one TF32 product "
          f"{', '.join(f'{x:.3e}' for x in fault)}")
    assert max(sound) <= atol
    assert max(fault) > atol


def _bench_bf16_inputs(cuda):
    """chip_smoke.py's bench_bf16 case (B 8, L 1024, H 16, D 64, causal):
    q, k, v as views of one fused qkv, dO, and the plain forward's LSE and
    delta."""
    B, L, H, D = 8, 1024, 16, 64
    gen = torch.Generator(device=cuda).manual_seed(1234)
    qkv = (torch.randn(B, L, 3, H, D, generator=gen, device=cuda) * 0.5).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = (torch.randn(B, L, H, D, generator=gen, device=cuda) * 0.5).to(torch.bfloat16)
    o, lse = fa.flash_forward_plain(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    return q, k, v, do, lse, delta


def _plant_fault(monkeypatch, tmp_path, source, sound, fault, edit=None):
    """Build a copy of ``source`` with ``sound`` replaced by ``fault`` in the
    file ``edit`` (``source`` itself by default, or a header it includes) and
    bind it in place of the sound library for the rest of the test."""
    from fedml_tpu_torch.ops import build

    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    edit = edit or source
    text = (src / edit).read_text()
    assert text.count(sound) == 1, "the planted fault no longer matches the kernel's source"
    (src / edit).write_text(text.replace(sound, fault))
    lib = tmp_path / f"lib{source}_fault.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src / source)],
                   check=True, capture_output=True)
    builds = dict(build.load().builds, **{source: {"path": str(lib)}})
    monkeypatch.setattr(build, "_LIBRARY", [build.KernelLibrary(builds)])


def test_bf16_dkv_tolerance_fails_a_planted_fault(cuda, tmp_path, monkeypatch):
    """At the TransformerLM bench shape (B 8, L 1024, H 16, D 64, causal; the
    inputs of chip_smoke.py's bench_bf16 case) the bf16 gradient tolerance
    passes the dK/dV kernel and fails a copy of it whose dK is wrong only in
    key tiles past the first, and there only off the diagonal q tile.  Prints
    the least atol each needs."""
    q, k, v, do, lse, delta = _bench_bf16_inputs(cuda)
    dk_r, dv_r = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True)
    atol, rtol = BF16_TOL["grad"]
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True)
    sound = (_least_atol(dk, dk_r, rtol), _least_atol(dv, dv_r, rtol))

    _plant_fault(monkeypatch, tmp_path, "flash_dkv_sm90.cu", SOUND_DK, FAULT_DK)
    dk_f, dv_f = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    fault = _least_atol(dk_f, dk_r, rtol)
    rms = dk_r.float().square().mean().sqrt().item()
    print(f"\nbf16 dK/dV at the bench shape: rms |dK| {rms:.3e}; least atol "
          f"at rtol {rtol}: sound dK {sound[0]:.3e}, dV {sound[1]:.3e}; planted fault dK "
          f"{fault:.3e}, max |err| {(dk_f.float() - dk_r.float()).abs().max().item():.3e}")
    assert max(sound) <= atol
    assert fault > atol
    # the fault is where it was planted: key tile 0, and dV, are untouched
    assert _least_atol(dk_f[:, :64], dk_r[:, :64], rtol) <= atol
    assert torch.equal(dv_f, dv)


def test_bf16_dq_tolerance_fails_a_planted_fault(cuda, tmp_path, monkeypatch):
    """At the bench shape the bf16 gradient tolerance passes the dQ kernel
    and fails a copy of it whose dS.K reads K from the ring's other stage
    past the first key tile, which leaves q tile 0 (it sees key tile 0 only)
    exactly as it was.  Prints the least atol each needs."""
    q, k, v, do, lse, delta = _bench_bf16_inputs(cuda)
    dq_r = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, True)
    atol, rtol = BF16_TOL["grad"]
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, True)
    sound = _least_atol(dq, dq_r, rtol)

    _plant_fault(monkeypatch, tmp_path, "flash_dq_sm90.cu", SOUND_DQ, FAULT_DQ)
    dq_f = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    fault = _least_atol(dq_f, dq_r, rtol)
    rms = dq_r.float().square().mean().sqrt().item()
    print(f"\nbf16 dQ at the bench shape: rms |dQ| {rms:.3e}; least atol at rtol {rtol}: "
          f"sound {sound:.3e}; planted fault {fault:.3e}, max |err| "
          f"{(dq_f.float() - dq_r.float()).abs().max().item():.3e}")
    assert sound <= atol
    assert fault > atol
    assert torch.equal(dq_f[:, :64], dq[:, :64])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_launches_all_three_kernels(cuda, dtype):
    q, k, v = (torch.randn(2, 40, 2, 32, device=cuda).to(dtype).requires_grad_()
               for _ in range(3))
    before = dict(fa.LAUNCHES)
    fa.attention(q, k, v).float().square().sum().backward()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        n: int(n in KERNELS[dtype]) for n in before}


def test_unsupported_head_dim_raises(cuda):
    q = torch.zeros(1, 8, 1, 16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_forward_cuda(q, q, q, True)


# name: (causal, Lq, Lk, q offset, key positions, carried state).  The ring's
# three fold kinds (keys before the rows, the diagonal, keys after the rows),
# ragged folds with a padded key tail, non-causal and causal, and unsorted
# positions: shuffled, and descending, which leaves the first key tiles dead
# for the first q tile only (the dead-tile skip on positions out of order).
FOLDS = {
    "past": (True, 128, 128, 128, "range", True),
    "diagonal": (True, 130, 130, 0, "range", False),
    "dead": (True, 128, 128, 0, "after", True),
    "ragged_full": (False, 70, 45, 0, "padded", True),
    "ragged_causal": (True, 200, 150, 60, "padded", True),
    "shuffled_causal": (True, 96, 100, 40, "shuffled", True),
    "reversed_causal": (True, 130, 256, 100, "reversed", True),
}
FOLD_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (3e-3, 1e-2)}
FOLD_KERNELS = {torch.float32: "flash_shard_update", torch.bfloat16: "flash_update_sm90"}


def _key_positions(kind, Lk, gen, device):
    idx = torch.arange(Lk, dtype=torch.int32, device=device)
    if kind == "range":
        return idx
    if kind == "after":
        return 10_000 + idx
    if kind == "padded":
        return torch.where(idx < Lk - 9, idx, -1)
    if kind == "reversed":
        return Lk - 1 - idx
    pos = torch.randperm(Lk, generator=gen, dtype=torch.int32, device=device)
    return torch.where(idx % 7 == 3, -1, pos)


def _fold_case(cuda, dtype, D, name):
    causal, Lq, Lk, q_off, keys, carried = FOLDS[name]
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = (torch.randn(2, Lq, 3, D, generator=gen, device=cuda) * 0.5).to(dtype)
    k, v = ((torch.randn(2, Lk, 3, D, generator=gen, device=cuda) * 0.5).to(dtype)
            for _ in range(2))
    q_pos = q_off + torch.arange(Lq, dtype=torch.int32, device=cuda)
    k_pos = _key_positions(keys, Lk, gen, cuda)
    m = torch.full((2, 3, Lq), float("-inf"), device=cuda)
    l = torch.zeros(2, 3, Lq, device=cuda)
    o = torch.zeros(2, Lq, 3, D, device=cuda)
    if carried:  # the state after folding the rows' own shard
        m, l, o = fa.flash_shard_update_plain(q, q, q, q_pos, q_pos, m, l, o, True)
    return (q, k, v, q_pos, k_pos, m, l, o), causal


@pytest.mark.parametrize("dtype,D", [(torch.float32, 32), (torch.float32, 64),
                                     (torch.bfloat16, 32), (torch.bfloat16, 64)])
@pytest.mark.parametrize("name", sorted(FOLDS))
def test_shard_update_kernel_matches_plain(cuda, dtype, D, name):
    args, causal = _fold_case(cuda, dtype, D, name)
    kernel = FOLD_KERNELS[dtype]
    before = dict(fa.LAUNCHES)
    got = fa.flash_shard_update_cuda(*args, causal)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        n: int(n == kernel) for n in before}
    m_r, l_r, o_r = fa.flash_shard_update_plain(*args, causal)
    m, l, o = got
    assert {t.dtype for t in got} == {torch.float32}
    torch.testing.assert_close(m, m_r, atol=1e-5, rtol=1e-6)  # equal infinities pass
    torch.testing.assert_close(l, l_r, atol=1e-5, rtol=1e-5)
    atol, rtol = FOLD_TOL[dtype]
    scale = l_r.clamp_min(1.0).permute(0, 2, 1)[..., None]
    err = (o - o_r).abs()
    assert bool((err <= atol * scale + rtol * o_r.abs()).all()), \
        f"o differs by {err.max().item():.3e} ({(err / scale).max().item():.3e} over max(l, 1))"
    if name == "dead":  # nothing live: the carried state passes through
        assert torch.equal(m, args[5]) and torch.equal(l, args[6]) and torch.equal(o, args[7])


def _dead_fold_passes_the_state_through(cuda, dtype, D):
    """A fold with no live key (every key after the rows, or padding) writes
    the carried state back bit for bit, every row of it: ragged Lq and Lk,
    rows still at m = -inf, outputs allocated over NaN."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    Lq, Lk = 100, 70
    q = torch.randn(2, Lq, 3, D, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(2, Lk, 3, D, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    q_pos = torch.arange(Lq, dtype=torch.int32, device=cuda)
    idx = torch.arange(Lk, dtype=torch.int32, device=cuda)
    k_pos = torch.where(idx % 2 == 0, 1000 + idx, -1)
    m = torch.randn(2, 3, Lq, generator=gen, device=cuda)
    l = torch.rand(2, 3, Lq, generator=gen, device=cuda) * 30
    o = torch.randn(2, Lq, 3, D, generator=gen, device=cuda)
    m[:, :, ::5], l[:, :, ::5], o[:, ::5] = float("-inf"), 0.0, 0.0  # rows that saw no key
    blocks = [torch.full_like(t, float("nan")) for t in (m, l, o)]
    del blocks  # the outputs come from these NaN blocks
    kernel = FOLD_KERNELS[dtype]
    before = fa.LAUNCHES[kernel]
    m2, l2, o2 = fa.flash_shard_update_cuda(q, k, v, q_pos, k_pos, m, l, o, True)
    assert fa.LAUNCHES[kernel] == before + 1
    assert torch.equal(m2, m) and torch.equal(l2, l) and torch.equal(o2, o)


@pytest.mark.parametrize("D", [32, 64])
def test_bf16_dead_fold_passes_the_state_through_bit_for_bit(cuda, D):
    _dead_fold_passes_the_state_through(cuda, torch.bfloat16, D)


@pytest.mark.parametrize("D", [32, 64])
def test_fp32_dead_fold_passes_the_state_through_bit_for_bit(cuda, D):
    _dead_fold_passes_the_state_through(cuda, torch.float32, D)


def _fold_least_atol(got, want, rtol):
    """The least atol, in units of max(l, 1), with which the fold's o passes."""
    scale = want[1].clamp_min(1.0).permute(0, 2, 1)[..., None]
    return (((got[2] - want[2]).abs() - rtol * want[2].abs()) / scale).clamp_min(0.0).max().item()


def test_fp32_fold_tolerance_fails_a_planted_fault(cuda, tmp_path, monkeypatch):
    """At every fold case of FOLDS (D 64) the fp32 fold tolerance (m atol
    1e-5 + rtol 1e-6, l 1e-5 + 1e-5, o 2e-5 + 1e-5 over max(l, 1)) passes the
    split-TF32 fold and fails a copy of it that takes one TF32 product per
    fp32 product (the two correction products removed from the shared
    split), on the fold whose keys all lie before the rows; the dead fold,
    which multiplies nothing, still passes its state through bit for bit.
    Prints the least atol of o each needs."""
    cases = {name: _fold_case(cuda, torch.float32, 64, name) for name in sorted(FOLDS)}
    want = {name: fa.flash_shard_update_plain(*args, causal)
            for name, (args, causal) in cases.items()}
    atol, rtol = FOLD_TOL[torch.float32]

    def folds():
        got = {name: fa.flash_shard_update_cuda(*args, causal)
               for name, (args, causal) in cases.items()}
        torch.cuda.synchronize()
        return got

    sound = folds()
    _plant_fault(monkeypatch, tmp_path, "flash_update.cu", SOUND_FWD, FAULT_FWD,
                 edit="flash_tf32.cuh")
    fault = folds()
    least = {name: (_fold_least_atol(sound[name], want[name], rtol),
                    _fold_least_atol(fault[name], want[name], rtol)) for name in cases}
    print("\nfp32 fold, D 64: least atol of o over max(l, 1) at rtol "
          f"{rtol} (split TF32, one TF32 product): "
          + "; ".join(f"{n} {a:.3e}, {b:.3e}" for n, (a, b) in least.items()))
    for name in cases:
        m, l, _ = sound[name]
        torch.testing.assert_close(m, want[name][0], atol=1e-5, rtol=1e-6)
        torch.testing.assert_close(l, want[name][1], atol=1e-5, rtol=1e-5)
        assert least[name][0] <= atol, name
    assert least["past"][1] > atol
    args = cases["dead"][0]
    assert all(torch.equal(a, b) for a, b in zip(fault["dead"], args[5:]))


def test_fp32_fold_rejects_what_cp_async_cannot_load(cuda):
    """The fp32 fold loads K/V tiles with 16-byte cp.async copies and the
    carried o two floats at a time: a head stride that is not a whole 16
    bytes, or a base off a 16-byte boundary, in q, k or v raises, and so does
    an o with an odd stride or a base off an 8-byte boundary; no kernel
    launches.  Fused-qkv views load as they are."""
    shape = (2, 70, 2, 64)
    good = torch.randn(shape, device=cuda)
    odd_stride = torch.zeros(2, 70, 2, 65, device=cuda)[..., :64]
    odd_base = torch.zeros(good.numel() + 1, device=cuda)[1:].view(shape)
    pos = torch.arange(70, dtype=torch.int32, device=cuda)
    m = torch.zeros(2, 2, 70, device=cuda)
    o = torch.zeros(shape, device=cuda)
    before = dict(fa.LAUNCHES)
    for bad in (odd_stride, odd_base):
        for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
            with pytest.raises(ValueError, match="cp.async"):
                fa.flash_shard_update_cuda(*args, pos, pos, m, m, o, True)
        with pytest.raises(ValueError, match="two floats"):
            fa.flash_shard_update_cuda(good, good, good, pos, pos, m, m, bad, True)
    assert fa.LAUNCHES == before
    qkv = torch.randn(2, 70, 3, 2, 64, device=cuda)
    fa.flash_shard_update_cuda(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], pos, pos, m, m, o, True)
    assert fa.LAUNCHES["flash_shard_update"] == before["flash_shard_update"] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_launches_the_fold_n_squared_times_and_matches_flash(cuda, dtype):
    from fedml_tpu_torch.parallel import create_mesh, ring_attention

    mesh = create_mesh((4,), ("sp",), cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 256, 2, 64, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    q.requires_grad_()
    kernel = FOLD_KERNELS[dtype]
    tol = (2e-5, 1e-5) if dtype == torch.float32 else BF16_TOL["o"]
    before = dict(fa.LAUNCHES)
    out = ring_attention(q, k, v, mesh)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        n: 16 * (n == kernel) for n in before}
    torch.testing.assert_close(out.float(), fa.flash_forward_plain(q.detach(), k, v, True)[0]
                               .float(), atol=tol[0], rtol=tol[1])
    out.float().square().sum().backward()  # the backward recomputes in torch: no launch
    assert fa.LAUNCHES[kernel] - before[kernel] == 16
    assert bool(q.grad.isfinite().all())


def test_shard_update_takes_only_int32_positions(cuda):
    args, causal = _fold_case(cuda, torch.float32, 32, "past")
    q, k, v, q_pos, k_pos, m, l, o = args
    with pytest.raises(ValueError, match="int32"):
        fa.flash_shard_update_cuda(q, k, v, q_pos.long(), k_pos, m, l, o, causal)


def test_shard_update_unsupported_head_dim_raises(cuda):
    q = torch.zeros(1, 8, 1, 16, device=cuda)
    pos = torch.arange(8, dtype=torch.int32, device=cuda)
    m, l = torch.zeros(1, 1, 8, device=cuda), torch.zeros(1, 1, 8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_shard_update_cuda(q, q, q, pos, pos, m, l, q, True)
