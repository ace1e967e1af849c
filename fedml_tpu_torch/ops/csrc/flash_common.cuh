// Shared device code of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Everything that decides WHICH scores live and HOW P and dS are rebuilt lives
// here once, so the forward and both backward kernels cannot drift apart: the
// masks, the online-softmax rescale, the log-sum-exp convention and
// block_grads (the counterpart of _block_grads in
// fedml_tpu/ops/flash_attention.py).
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, L, H, D] tensors read through
// element strides (the last dim must be contiguous); lse and delta are
// contiguous [B, H, L] fp32.  Arithmetic is fp32 FMA throughout (never TF32);
// bf16 inputs are widened exactly, and the values the JAX kernel casts to the
// input type before a product (P before P.V and P^T.dO, dS before dS.K and
// dS^T.Q) are rounded to bf16 the same way here.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace flash {

// Element strides of one [B, L, H, D] tensor (the D stride is 1).
struct Strides {
  long long b, l, h;
};

inline Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
};

// x rounded to the input type and widened back: the cast the JAX kernel makes
// before a product in the input dtype (identity for fp32).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Cvt<T>::to_f(Cvt<T>::from_f(x));
}

__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) < CUDART_INF_F; }

// A key contributes to a query row iff it lies inside the sequence and, when
// causal, not after the row.
__device__ __forceinline__ bool key_live(int q_pos, int k_pos, int L, int causal) {
  return k_pos < L && (!causal || q_pos >= k_pos);
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

// Stage rows [row0, row0 + ROWS) of one (b, h) slice into shared memory as
// fp32, ld floats apart.  Rows at or past L are zero.  Neighbouring threads
// read neighbouring elements of a row.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* __restrict__ src,
                                          Strides s, int b, int h, int row0, int L, int tid,
                                          int nthreads) {
  for (int e = tid; e < ROWS * D; e += nthreads) {
    const int r = e / D;
    const int c = e - r * D;
    const int pos = row0 + r;
    float val = 0.f;
    if (pos < L) {
      val = Cvt<T>::to_f(src[(long long)b * s.b + (long long)pos * s.l + (long long)h * s.h + c]);
    }
    dst[r * ld + c] = val;
  }
}

// Write rows [row0, row0 + ROWS) from shared memory back to one (b, h) slice,
// skipping rows at or past L.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, Strides s, const float* src,
                                           int ld, int b, int h, int row0, int L, int tid,
                                           int nthreads) {
  for (int e = tid; e < ROWS * D; e += nthreads) {
    const int r = e / D;
    const int c = e - r * D;
    const int pos = row0 + r;
    if (pos < L) {
      dst[(long long)b * s.b + (long long)pos * s.l + (long long)h * s.h + c] =
          Cvt<T>::from_f(src[r * ld + c]);
    }
  }
}

}  // namespace flash
