"""Flash attention of the port: hand-written CUDA kernels and their plain twins.

Counterpart of ``fedml_tpu/ops/flash_attention.py``.  Each of the four Pallas
kernels has two CUDA kernels for Hopper, one per input type, all four of
each on the tensor cores: in fp32 (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``, ``csrc/flash_update.cu``) in split TF32 (three TF32
products per fp32 product, ``csrc/flash_tf32.cuh``); in bf16
(``csrc/flash_fwd_sm90.cu``, ``csrc/flash_dq_sm90.cu``,
``csrc/flash_dkv_sm90.cu``, ``csrc/flash_update_sm90.cu``).  Beside them here
is a plain PyTorch version of the same function that materialises the scores:

=========================  =================================  ==================================
JAX package (Pallas)       CUDA wrapper                       plain version
=========================  =================================  ==================================
``_flash_kernel``          :func:`flash_forward_cuda`         :func:`flash_forward_plain`
``_flash_bwd_dq_kernel``   :func:`flash_bwd_dq_cuda`          :func:`flash_bwd_dq_plain`
``_flash_bwd_dkv_kernel``  :func:`flash_bwd_dkv_cuda`         :func:`flash_bwd_dkv_plain`
``_flash_update_kernel``   :func:`flash_shard_update_cuda`    :func:`flash_shard_update_plain`
=========================  =================================  ==================================

The fourth is ring attention's shard fold: one K/V shard folded into a carried
online-softmax state (m, l, unnormalised o), with positions given as arrays.
Its backward, as in the JAX package, is no kernel: it recomputes through
:func:`shard_update_reference`, the fused form of the same fold.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel (or the
wrapper raises), a CPU tensor takes the plain version.  Nothing falls back.
Each CUDA wrapper adds one to ``LAUNCHES[kernel]`` for the kernel it launches:
``flash_fwd_sm90``, ``flash_dq_sm90``, ``flash_dkv_sm90`` and
``flash_update_sm90`` count the bf16 tensor-core kernels, ``flash_fwd``,
``flash_bwd_dq``, ``flash_bwd_dkv`` and ``flash_shard_update`` the fp32 ones.
The bf16 kernels load tiles with TMA and the fp32 kernels with 16-byte
``cp.async`` copies: each takes a tensor only if its base is 16-byte aligned
and its (b, l, h) strides are whole 16 bytes (8 bf16 or 4 fp32 elements, so
the model's fused-qkv views load as they are); the shard fold in both types
also moves its carried o two floats at a time.  Anything else raises.

Conventions shared by both routes (those of the JAX kernels): q, k, v, o are
[B, L, H, D]; scores are scaled by 1/sqrt(D); keys past L and, when causal,
keys after the row are masked; the LSE is fp32 [B, H, L] (-inf for a row with
no live key); products take their operands in the input dtype with fp32
accumulation, so in bf16 P and dS are rounded to bf16 before their products.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

#: launches of each CUDA kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_fwd_sm90": 0, "flash_bwd_dq": 0,
                            "flash_dq_sm90": 0, "flash_bwd_dkv": 0, "flash_dkv_sm90": 0,
                            "flash_shard_update": 0, "flash_update_sm90": 0}

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_HEAD_DIMS = (32, 64)
_MAX_GRID_Y = 65535
_ALIGN_BYTES = 16  # TMA (bf16 kernels) and cp.async (fp32 kernels) copies
# negative status codes of the tensor-map (TMA) entry points, csrc/flash_sm90.cuh
_TMA_ERRORS = {-1: "the CUDA driver has no cuTensorMapEncodeTiled",
               -2: "the CUDA driver refused a tensor map for these strides"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def reference_attention(q, k, v, causal: bool = True):
    """Fused-softmax attention, [B, L, H, D] layout: the oracle the flash
    kernels are held to (``reference_attention`` of the JAX package)."""
    d = q.shape[-1]
    scores = torch.einsum("blhd,bmhd->bhlm", q, k).float() / math.sqrt(d)
    if causal:
        L, M = q.shape[1], k.shape[1]
        mask = torch.ones((L, M), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhlm,bmhd->blhd", probs, v)


# ---------------------------------------------------------------------------
# plain versions: the same functions as the kernels, scores materialised
# ---------------------------------------------------------------------------
def _live(L: int, causal: bool, device) -> torch.Tensor:
    """[L, L] mask of live (query, key) pairs."""
    live = torch.ones((L, L), dtype=torch.bool, device=device)
    return live.tril() if causal else live


def _scores(q, k):
    """Scaled scores [B, H, L, L] in fp32 from inputs widened exactly."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale


def flash_forward_plain(q, k, v, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O [B, L, H, D] in q's dtype, LSE [B, H, L] fp32)."""
    live = _live(q.shape[1], causal, q.device)
    s = _scores(q, k).masked_fill(~live, float("-inf"))
    m = s.amax(dim=-1)
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - safe_m[..., None]).masked_fill(~live, 0.0)
    l = p.sum(dim=-1)
    pv = torch.einsum("bhlm,bmhd->blhd", p.to(v.dtype).float(), v.float())
    o = pv / l.clamp_min(1e-20).permute(0, 2, 1)[..., None]
    lse = torch.where(l > 0, safe_m + torch.log(l.clamp_min(1e-38)),
                      torch.full_like(l, float("-inf")))
    return o.to(q.dtype), lse


def _block_grads(q, k, v, do, lse, delta, causal):
    """P and dS [B, H, L, L] rebuilt from (q, k, lse): the plain form of the
    kernels' shared ``block_grads``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    live = _live(q.shape[1], causal, q.device) & torch.isfinite(lse)[..., None]
    s = _scores(q, k)
    shift = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.where(live, torch.exp(s - shift[..., None]), torch.zeros_like(s))
    dp = torch.einsum("blhd,bmhd->bhlm", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True) -> torch.Tensor:
    """dQ [B, L, H, D] in q's dtype; delta = rowsum(dO * O) as [B, H, L] fp32."""
    _, ds = _block_grads(q, k, v, do, lse, delta, causal)
    return torch.einsum("bhlm,bmhd->blhd", ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True):
    """(dK, dV), each [B, L, H, D] in q's dtype."""
    p, ds = _block_grads(q, k, v, do, lse, delta, causal)
    dv = torch.einsum("bhlm,blhd->bmhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhlm,blhd->bmhd", ds.to(q.dtype).float(), q.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def _live_at(q_pos, k_pos, causal: bool) -> torch.Tensor:
    """[Lq, Lk] (or [1, Lk]) mask of live pairs from positions carried as data:
    k_pos < 0 is padding and, when causal, a key after the row is dead."""
    live = (k_pos >= 0)[None, :]
    if causal:
        live = live & (q_pos[:, None] >= k_pos[None, :])
    return live


def _fold(s, live, v, m, l, o, p_dtype: torch.dtype):
    """Fold fp32 scaled scores s [B, H, Lq, Lk], live where ``live``, into the
    running (m, l, o); P enters P.V rounded to ``p_dtype``."""
    s = s.masked_fill(~live, float("-inf"))
    new_m = torch.maximum(m, s.amax(dim=-1))
    # a row with no live key so far keeps m = -inf: shift by 0, not by -inf
    safe_m = torch.where(torch.isfinite(new_m), new_m, torch.zeros_like(new_m))
    p = torch.exp(s - safe_m[..., None]).masked_fill(~live, 0.0)
    correction = torch.where(torch.isfinite(m), torch.exp(m - safe_m), torch.zeros_like(m))
    new_l = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhlm,bmhd->blhd", p.to(p_dtype).float(), v.float())
    new_o = o * correction.permute(0, 2, 1)[..., None] + pv
    return new_m, new_l, new_o


def shard_update_reference(q, k, v, q_pos, k_pos, causal: bool, m, l, o):
    """The fused form of ring attention's shard fold (``shard_update_reference``
    of the JAX package): ring attention's plain block function and the
    recompute behind :class:`FlashShardUpdate`'s backward.

    q [B, Lq, H, D]; k, v [B, Lk, H, D]; q_pos [Lq] and k_pos [Lk] global
    positions, int32 (the kernel takes no other type); (m [B, H, Lq], l [B, H, Lq], o [B, Lq, H, D]) the running max,
    denominator and unnormalised output, fp32.  As in the JAX reference the
    scores come from a product in the input dtype (rounded to bf16 in bf16)
    and P enters P.V unrounded in fp32."""
    scores = torch.einsum("blhd,bmhd->bhlm", q, k).float() / math.sqrt(q.shape[-1])
    return _fold(scores, _live_at(q_pos, k_pos, causal), v, m, l, o, torch.float32)


def flash_shard_update_plain(q, k, v, q_pos, k_pos, m, l, o, causal: bool = True):
    """K4's function with the scores materialised: (m, l, o) after folding the
    shard (k, v) into the carried state, all fp32.  Unlike
    :func:`shard_update_reference` it follows the kernel in bf16: the scores
    are fp32 products of the widened inputs and P is rounded to V's type
    before P.V.  In fp32 the two are the same function."""
    return _fold(_scores(q, k), _live_at(q_pos, k_pos, causal), v, m, l, o, v.dtype)


# ---------------------------------------------------------------------------
# CUDA wrappers: check, allocate, launch on the current stream, count
# ---------------------------------------------------------------------------
def _check(name: str, *tensors: torch.Tensor) -> Tuple[int, int, int, int]:
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"{name}: expected [B, L, H, D] tensors, got {tuple(q.shape)}")
    B, L, H, D = q.shape
    for t in tensors:
        if not t.is_cuda:
            raise RuntimeError(f"{name}: the CUDA kernel takes CUDA tensors, got {t.device}")
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: q, k, v (and dO) must share shape, dtype and device")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous (stride {t.stride()})")
    _check_limits(name, q.dtype, B, H, D)
    return B, L, H, D


def _check_limits(name: str, dtype: torch.dtype, B: int, H: int, D: int) -> None:
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: dtype {dtype} not supported (float32, bfloat16)")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not supported {KERNEL_HEAD_DIMS}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"{name}: B*H = {B * H} exceeds the grid limit {_MAX_GRID_Y}")


def _check_rows(name: str, q: torch.Tensor, *rows: torch.Tensor) -> None:
    B, L, H, _ = q.shape
    for r in rows:
        if (r.shape != (B, H, L) or r.dtype != torch.float32 or r.device != q.device
                or not r.is_contiguous()):
            raise ValueError(f"{name}: row statistics (lse, delta, m, l) must be contiguous "
                             f"fp32 [B, H, L] on {q.device}, got {tuple(r.shape)} {r.dtype} "
                             f"{r.device}")


def _check_update(name: str, q, k, v, q_pos, k_pos, m, l, o) -> Tuple[int, int, int, int, int]:
    """Shapes, types and devices of a shard fold: (B, Lq, H, D, Lk)."""
    for t in (q, k, v, q_pos, k_pos, m, l, o):
        if not t.is_cuda:
            raise RuntimeError(f"{name}: the CUDA kernel takes CUDA tensors, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name}: every input must lie on {q.device}, got {t.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: expected [B, L, H, D] q, k, v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if k.shape != (B, Lk, H, D) or v.shape != k.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: k and v must be [B, Lk, H, D] in q's dtype, got "
                         f"{tuple(k.shape)} {k.dtype}, {tuple(v.shape)} {v.dtype}")
    if o.shape != (B, Lq, H, D) or o.dtype != torch.float32:
        raise ValueError(f"{name}: o must be fp32 [B, Lq, H, D], got {tuple(o.shape)} {o.dtype}")
    for t in (q, k, v, o):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous (stride {t.stride()})")
    for pos, n in ((q_pos, Lq), (k_pos, Lk)):
        if pos.shape != (n,) or pos.dtype != torch.int32 or not pos.is_contiguous():
            raise ValueError(f"{name}: positions must be contiguous int32 [{n}], got "
                             f"{tuple(pos.shape)} {pos.dtype}")
    _check_rows(name, q, m, l)
    _check_limits(name, q.dtype, B, H, D)
    return B, Lq, H, D, Lk


def tma_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """(b, l, h) element strides of a [B, L, H, D] tensor as the kernels take
    them: the stride of a dim of size 1 is never stepped, so it is replaced
    by the dense one, which a TMA tensor map can take whatever torch reports
    for that dim."""
    B, L, H, D = t.shape
    sh = t.stride(2) if H > 1 else D
    sl = t.stride(1) if L > 1 else H * sh
    sb = t.stride(0) if B > 1 else L * sl
    return sb, sl, sh


def _check_16b(name: str, why: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor can be loaded 16 bytes at a time: base 16-byte
    aligned, (b, l, h) strides multiples of 16 bytes (the D stride is 1,
    checked by _check).  ``why`` names the kernel's copies in the message."""
    for t in tensors:
        elt = t.element_size()
        if t.data_ptr() % _ALIGN_BYTES or any(
                (s * elt) % _ALIGN_BYTES for s in tma_strides(t)):
            raise ValueError(f"{name}: {why}, which needs a 16-byte aligned base and (b, l, h) "
                             f"strides of whole 16 bytes; got base {t.data_ptr():#x} and "
                             f"strides {t.stride()}")


def _check_tma(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless TMA can load every tensor (the bf16 kernels)."""
    _check_16b(name, "the bf16 kernel loads tiles with TMA", *tensors)


def _check_cp_async(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless 16-byte cp.async copies can load every tensor (the fp32
    split-TF32 kernels)."""
    _check_16b(name, "the fp32 kernel loads tiles with 16-byte cp.async copies", *tensors)


def _check_pairs(name: str, t: torch.Tensor) -> None:
    """Raise unless the fold (either type) can move the fp32 state two floats
    at a time: an 8-byte aligned base and even (b, l, h) strides."""
    if t.data_ptr() % 8 or any(s % 2 for s in tma_strides(t)):
        raise ValueError(f"{name}: the fold moves o two floats at a time, which needs an "
                         f"8-byte aligned base and even strides; got base {t.data_ptr():#x} "
                         f"and strides {t.stride()}")


def _strides(*tensors: torch.Tensor):
    vals = []
    for t in tensors:
        vals += tma_strides(t)
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err in _TMA_ERRORS:
        raise RuntimeError(f"{name}: {_TMA_ERRORS[err]}")
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    LAUNCHES[name] += 1


def _scale(D: int) -> float:
    return float(1.0 / (D ** 0.5))


def flash_forward_cuda(q, k, v, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on the card: (O, LSE) as :func:`flash_forward_plain`, on the tensor
    cores in both types: bf16 by ``wgmma`` (``flash_fwd_sm90.cu``), fp32 in
    split TF32 by ``mma.sync`` (``flash_fwd.cu``)."""
    from .build import load

    B, L, H, D = _check("flash_fwd", q, k, v)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_tma("flash_fwd", q, k, v)
    else:
        _check_cp_async("flash_fwd", q, k, v)
    lib = load()
    o = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    st = _strides(q, k, v, o)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kernel = "flash_fwd_sm90" if bf16 else "flash_fwd"
    _launch(kernel, getattr(lib, kernel), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, L, D, int(causal),
            _scale(D), ctypes.cast(st, ctypes.c_void_p), stream)
    return o, lse


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool = True) -> torch.Tensor:
    """K2 on the card: dQ as :func:`flash_bwd_dq_plain`, on the tensor cores
    in both types: bf16 by ``wgmma`` (``flash_dq_sm90.cu``), fp32 in split
    TF32 by ``mma.sync`` (``flash_bwd.cu``)."""
    from .build import load

    B, L, H, D = _check("flash_bwd_dq", q, k, v, do)
    _check_rows("flash_bwd_dq", q, lse, delta)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_tma("flash_bwd_dq", q, k, v, do)
    else:
        _check_cp_async("flash_bwd_dq", q, k, v, do)
    lib = load()
    dq = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    st = _strides(q, k, v, do, dq)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kernel = "flash_dq_sm90" if bf16 else "flash_bwd_dq"
    _launch(kernel, getattr(lib, kernel), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, L, D,
            int(causal), _scale(D), ctypes.cast(st, ctypes.c_void_p), stream)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool = True):
    """K3 on the card: (dK, dV) as :func:`flash_bwd_dkv_plain`, on the tensor
    cores in both types: bf16 by ``wgmma`` (``flash_dkv_sm90.cu``), fp32 in
    split TF32 by ``mma.sync`` (``flash_bwd.cu``)."""
    from .build import load

    B, L, H, D = _check("flash_bwd_dkv", q, k, v, do)
    _check_rows("flash_bwd_dkv", q, lse, delta)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_tma("flash_bwd_dkv", q, k, v, do)
    else:
        _check_cp_async("flash_bwd_dkv", q, k, v, do)
    lib = load()
    dk = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    st = _strides(q, k, v, do, dk, dv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kernel = "flash_dkv_sm90" if bf16 else "flash_bwd_dkv"
    _launch(kernel, getattr(lib, kernel), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, L, D, int(causal), _scale(D),
            ctypes.cast(st, ctypes.c_void_p), stream)
    return dk, dv


def flash_shard_update_cuda(q, k, v, q_pos, k_pos, m, l, o, causal: bool = True):
    """K4 on the card: (m, l, o) as :func:`flash_shard_update_plain`, on the
    tensor cores in both types: bf16 by ``wgmma`` (``flash_update_sm90.cu``),
    fp32 in split TF32 by ``mma.sync`` (``flash_update.cu``)."""
    from .build import load

    B, Lq, H, D, Lk = _check_update("flash_shard_update", q, k, v, q_pos, k_pos, m, l, o)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_tma("flash_shard_update", q, k, v)
    else:
        _check_cp_async("flash_shard_update", q, k, v)
    _check_pairs("flash_shard_update", o)
    lib = load()
    m_out = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    l_out = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    o_out = torch.empty((B, Lq, H, D), dtype=torch.float32, device=q.device)
    st = _strides(q, k, v, o, o_out)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kernel, fn = ("flash_update_sm90", lib.flash_update_sm90) if bf16 else \
        ("flash_shard_update", lib.flash_update)
    _launch(kernel, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_pos.data_ptr(), k_pos.data_ptr(), m.data_ptr(), l.data_ptr(), o.data_ptr(),
            m_out.data_ptr(), l_out.data_ptr(), o_out.data_ptr(), B, H, Lq, Lk, D,
            int(causal), _scale(D), ctypes.cast(st, ctypes.c_void_p), stream)
    return m_out, l_out, o_out


# ---------------------------------------------------------------------------
# dispatch by device, and the autograd Function over it
# ---------------------------------------------------------------------------
def _route(q: torch.Tensor, cuda_fn, plain_fn):
    if q.is_cuda:
        return cuda_fn
    if q.device.type == "cpu":
        return plain_fn
    raise RuntimeError(f"flash attention has no route for device {q.device}")


def flash_forward(q, k, v, causal: bool = True):
    return _route(q, flash_forward_cuda, flash_forward_plain)(q, k, v, causal)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True):
    return _route(q, flash_bwd_dq_cuda, flash_bwd_dq_plain)(q, k, v, do, lse, delta, causal)


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True):
    return _route(q, flash_bwd_dkv_cuda, flash_bwd_dkv_plain)(q, k, v, do, lse, delta, causal)


def _first_order_only(name: str) -> None:
    """Refuse a backward that is to be differentiated again: autograd runs a
    backward with grad mode on only under ``create_graph``."""
    if torch.is_grad_enabled():
        raise RuntimeError(
            f"{name} is once-differentiable: its backward's outputs carry no graph, so a "
            "second derivative (create_graph=True) through it is refused")


class FlashAttention(torch.autograd.Function):
    """The ``flash_attention`` custom_vjp of the JAX package: the forward
    returns (O, LSE) and saves (q, k, v, O, LSE); the backward rebuilds P
    blockwise in two kernels (dQ, then dK/dV) from delta = rowsum(dO * O), a
    plain torch op here as it is an XLA op there.  The kernels' outputs carry
    no graph, so the backward is once-differentiable: asked for a graph of
    the gradient (``create_graph``), it raises instead of dropping the second
    derivative's terms.

    Under ``torch.func.vmap`` (the chunked round, ``xla_client_chunk``) the
    ``vmap`` rule folds the mapped dim into the batch, as JAX batches a
    ``pallas_call``: q/k/v ``[k, B, L, H, D]`` become one contiguous
    ``[k*B, L, H, D]`` call, so each kernel launches once for the k clients,
    and the inner call's autograd node runs K2 and K3 once at ``k*B`` too."""

    @staticmethod
    def forward(q, k, v, causal: bool = True):
        return flash_forward(q, k, v, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal = causal

    @staticmethod
    def backward(ctx, g, _g_lse):
        _first_order_only("flash attention")
        q, k, v, o, lse = ctx.saved_tensors
        do = g.to(q.dtype).contiguous()
        delta = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal: bool = True):
        n = info.batch_size

        def fold(t, d):
            t = t.unsqueeze(0).expand(n, *t.shape) if d is None else t.movedim(d, 0)
            return t.reshape((n * t.shape[1],) + tuple(t.shape[2:])).contiguous()

        q, k, v = (fold(t, d) for t, d in zip((q, k, v), in_dims[:3]))
        o, lse = FlashAttention.apply(q, k, v, causal)
        return (o.reshape((n, -1) + tuple(o.shape[1:])),
                lse.reshape((n, -1) + tuple(lse.shape[1:]))), (0, 0)


def flash_attention(q, k, v, causal: bool = True):
    """Differentiable flash attention, q/k/v [B, L, H, D] -> [B, L, H, D]."""
    return FlashAttention.apply(q, k, v, causal)[0]


class FlashShardUpdate(torch.autograd.Function):
    """The ``flash_shard_update`` custom_vjp of the JAX package: the forward
    folds the shard through K4 (its plain twin on the CPU); the backward
    recomputes the fold through :func:`shard_update_reference` and takes its
    gradients, as the JAX package's vjp does.  Positions get no gradient.
    That backward keeps no graph of its own, so it is once-differentiable:
    asked for a graph of the gradient, it raises."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, m, l, o, causal: bool = True):
        out = _route(q, flash_shard_update_cuda, flash_shard_update_plain)(
            q, k, v, q_pos, k_pos, m, l, o, causal)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, m, l, o)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, gm, gl, go):
        _first_order_only("the flash shard fold")
        q, k, v, q_pos, k_pos, m, l, o = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in (q, k, v, m, l, o)]
            outs = shard_update_reference(*args[:3], q_pos, k_pos, ctx.causal, *args[3:])
            dq, dk, dv, dm, dl, do = torch.autograd.grad(outs, args, (gm, gl, go))
        return dq, dk, dv, None, None, dm, dl, do, None


def flash_shard_update(q, k, v, q_pos, k_pos, m, l, o, causal: bool = True):
    """Differentiable shard fold: (m, l, o) after folding (k, v) into the
    carried state; the layouts of :func:`shard_update_reference`."""
    return FlashShardUpdate.apply(q, k, v, q_pos, k_pos, m, l, o, causal)


def attention(q, k, v, causal: bool = True):
    """The model's attention: the CUDA kernels for CUDA tensors, their plain
    versions for CPU tensors (dispatch is by device, in the Function)."""
    return flash_attention(q, k, v, causal)
