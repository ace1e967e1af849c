// Shared device code of the flash-attention kernels: the fp32 kernels
// (flash_fwd.cu, flash_bwd.cu, flash_update.cu) and the bf16 tensor-core
// kernels (flash_fwd_sm90.cu, flash_dq_sm90.cu, flash_dkv_sm90.cu,
// flash_update_sm90.cu).
//
// Everything that decides WHICH scores live and HOW P and dS are rebuilt lives
// here once, so the forward, both backward kernels and the shard fold cannot
// drift apart: the masks, the online-softmax rescale, the log-sum-exp
// convention and block_grads (the counterpart of _block_grads in
// fedml_tpu/ops/flash_attention.py).
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, L, H, D] tensors read through
// element strides (the last dim must be contiguous); lse and delta are
// contiguous [B, H, L] fp32.  Sums are fp32 throughout.  The fp32 tensor-core
// kernels (forward, dQ, dK/dV) take each product as three TF32 products of
// split operands (flash_tf32.cuh), fp32-exact to about 2^-21; the shard fold
// (flash_update.cu) multiplies on fp32 FMAs.  The bf16 kernels multiply bf16
// exactly on the tensor cores and round to bf16 the values the JAX kernel
// casts to the input type before a product (P before P.V and P^T.dO, dS
// before dS.K and dS^T.Q).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

// Element strides of one [B, L, H, D] tensor (the D stride is 1).
struct Strides {
  long long b, l, h;
};

inline Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) < CUDART_INF_F; }

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Max and sum over the 4 threads of a quad, which share a row of an mma
// fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A key contributes to a query row iff it lies inside the sequence and, when
// causal, not after the row.
__device__ __forceinline__ bool key_live(int q_pos, int k_pos, int L, int causal) {
  return k_pos < L && (!causal || q_pos >= k_pos);
}

// The same test on positions carried as data (ring attention's shard fold):
// a key is live iff it is not padding (k_pos >= 0) and, when causal, not after
// the row.  Positions need not be sorted or contiguous.
__device__ __forceinline__ bool key_live_at(int q_pos, int k_pos, int causal) {
  return k_pos >= 0 && (!causal || q_pos >= k_pos);
}

// Online-softmax rescale: fold a chunk whose largest live score is cmax into
// the running max m.  Sets safe_m (the finite shift for exp) and returns the
// factor that rescales the running denominator and accumulator; a row that
// has seen no live key yet keeps m = -inf and gets factor 0.
__device__ __forceinline__ float online_rescale(float& m, float cmax, float& safe_m) {
  const float new_m = fmaxf(m, cmax);
  safe_m = is_finite(new_m) ? new_m : 0.f;
  const float corr = is_finite(m) ? expf(m - safe_m) : 0.f;
  m = new_m;
  return corr;
}

// Per-row log-sum-exp of the scaled scores; -inf for a row with no live key.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (is_finite(m) ? m : 0.f) + logf(fmaxf(l, 1e-38f)) : -CUDART_INF_F;
}

// One (query row, key) pair of the backward: rebuild P from the scaled score s
// and the row's lse, then dS = P * (dP - delta) * scale.
__device__ __forceinline__ void block_grads(float s, float dp, float lse, float delta, bool live,
                                            float scale, float& p, float& ds) {
  p = (live && is_finite(lse)) ? expf(s - lse) : 0.f;
  ds = p * (dp - delta) * scale;
}

// Stage rows [row0, row0 + ROWS) of one fp32 (b, h) slice into shared memory,
// ld floats apart.  Rows at or past L are zero.  Neighbouring threads read
// neighbouring elements of a row.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                                          Strides s, int b, int h, int row0, int L, int tid,
                                          int nthreads) {
  for (int e = tid; e < ROWS * D; e += nthreads) {
    const int r = e / D;
    const int c = e - r * D;
    const int pos = row0 + r;
    float val = 0.f;
    if (pos < L) {
      val = src[(long long)b * s.b + (long long)pos * s.l + (long long)h * s.h + c];
    }
    dst[r * ld + c] = val;
  }
}

// Write rows [row0, row0 + ROWS) from shared memory back to one (b, h) slice,
// skipping rows at or past L.
template <int D, int ROWS>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, Strides s, const float* src,
                                           int ld, int b, int h, int row0, int L, int tid,
                                           int nthreads) {
  for (int e = tid; e < ROWS * D; e += nthreads) {
    const int r = e / D;
    const int c = e - r * D;
    const int pos = row0 + r;
    if (pos < L) {
      dst[(long long)b * s.b + (long long)pos * s.l + (long long)h * s.h + c] = src[r * ld + c];
    }
  }
}

}  // namespace flash
