"""Flash attention of the port: hand-written CUDA kernels and their plain twins.

Counterpart of ``fedml_tpu/ops/flash_attention.py``.  The three Pallas
kernels on the training path each have a CUDA kernel for Hopper
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) and, beside it here, a plain
PyTorch version of the same function that materialises the scores:

=========================  ===============================  ============================
JAX package (Pallas)       CUDA wrapper                     plain version
=========================  ===============================  ============================
``_flash_kernel``          :func:`flash_forward_cuda`       :func:`flash_forward_plain`
``_flash_bwd_dq_kernel``   :func:`flash_bwd_dq_cuda`        :func:`flash_bwd_dq_plain`
``_flash_bwd_dkv_kernel``  :func:`flash_bwd_dkv_cuda`       :func:`flash_bwd_dkv_plain`
=========================  ===============================  ============================

Dispatch is by the tensor's device: a CUDA tensor launches the kernel (or the
wrapper raises), a CPU tensor takes the plain version.  Nothing falls back.
Each CUDA wrapper adds one to ``LAUNCHES[name]`` where it launches.

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
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (32, 64)
_MAX_GRID_Y = 65535


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
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not supported {KERNEL_HEAD_DIMS}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"{name}: B*H = {B * H} exceeds the grid limit {_MAX_GRID_Y}")
    return B, L, H, D


def _check_rows(name: str, q: torch.Tensor, *rows: torch.Tensor) -> None:
    B, L, H, _ = q.shape
    for r in rows:
        if (r.shape != (B, H, L) or r.dtype != torch.float32 or r.device != q.device
                or not r.is_contiguous()):
            raise ValueError(f"{name}: lse/delta must be contiguous fp32 [B, H, L] on "
                             f"{q.device}, got {tuple(r.shape)} {r.dtype} {r.device}")


def _strides(*tensors: torch.Tensor):
    vals = []
    for t in tensors:
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    LAUNCHES[name] += 1


def _scale(D: int) -> float:
    return float(1.0 / (D ** 0.5))


def flash_forward_cuda(q, k, v, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on the card: (O, LSE) as :func:`flash_forward_plain`."""
    from .build import load

    B, L, H, D = _check("flash_fwd", q, k, v)
    lib = load()
    o = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    st = _strides(q, k, v, o)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch("flash_fwd", lib.flash_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, L, D, KERNEL_DTYPES[q.dtype], int(causal), _scale(D),
            ctypes.cast(st, ctypes.c_void_p), stream)
    return o, lse


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool = True) -> torch.Tensor:
    """K2 on the card: dQ as :func:`flash_bwd_dq_plain`."""
    from .build import load

    B, L, H, D = _check("flash_bwd_dq", q, k, v, do)
    _check_rows("flash_bwd_dq", q, lse, delta)
    lib = load()
    dq = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    st = _strides(q, k, v, do, dq)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch("flash_bwd_dq", lib.flash_bwd_dq, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, L, D,
            KERNEL_DTYPES[q.dtype], int(causal), _scale(D), ctypes.cast(st, ctypes.c_void_p),
            stream)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool = True):
    """K3 on the card: (dK, dV) as :func:`flash_bwd_dkv_plain`."""
    from .build import load

    B, L, H, D = _check("flash_bwd_dkv", q, k, v, do)
    _check_rows("flash_bwd_dkv", q, lse, delta)
    lib = load()
    dk = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    st = _strides(q, k, v, do, dk, dv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch("flash_bwd_dkv", lib.flash_bwd_dkv, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, L, D, KERNEL_DTYPES[q.dtype], int(causal), _scale(D),
            ctypes.cast(st, ctypes.c_void_p), stream)
    return dk, dv


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


class FlashAttention(torch.autograd.Function):
    """The ``flash_attention`` custom_vjp of the JAX package: the forward
    saves (q, k, v, O, LSE); the backward rebuilds P blockwise in two kernels
    (dQ, then dK/dV) from delta = rowsum(dO * O), a plain torch op here as it
    is an XLA op there."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True):
        o, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        do = g.to(q.dtype).contiguous()
        delta = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    """Differentiable flash attention, q/k/v [B, L, H, D] -> [B, L, H, D]."""
    return FlashAttention.apply(q, k, v, causal)


def attention(q, k, v, causal: bool = True):
    """The model's attention: the CUDA kernels for CUDA tensors, their plain
    versions for CPU tensors (dispatch is by device, in the Function)."""
    return flash_attention(q, k, v, causal)
