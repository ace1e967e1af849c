// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV.
//
// Replaces: fedml_tpu/ops/flash_attention.py:_flash_bwd_dq_kernel and
// fedml_tpu/ops/flash_attention.py:_flash_bwd_dkv_kernel (the two Pallas TPU
// kernels launched by _flash_backward).  Both rebuild P from (q, k, lse) and
// form dS = P * (dO.V^T - delta) * scale through the one block_grads of
// flash_common.cuh, so the two gradients cannot drift apart; delta =
// rowsum(dO * O) comes in precomputed, as in the JAX package.
//   dQ = sum over keys of dS . K
//   dV = sum over queries of P^T . dO,  dK = sum over queries of dS^T . Q
//
// What bounds them on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores, 989 TFLOP/s bf16 dense):
// - the slice's shape (B 32, L 80, H 8, D 32, fp32, causal): dQ moves 13.3 MB
//   for 0.16 GFLOP, dK/dV 15.9 MB for 0.21 GFLOP, so bytes: 4 and 5 us;
// - L 1024 (B 8, H 16, D 64, causal): dQ does 25.8 GFLOP and dK/dV 34.4
//   GFLOP.  In fp32 that is 385 and 513 us at the fp32 rate against 50 and
//   60 us of bytes, so operations; in bf16, 26 and 35 us at the tensor-core
//   peak against 25 and 30 us of bytes.
//
// Design: dQ runs one block per (64-row query tile, b*h), one thread per
// query row with its q and dO rows in shared memory and its fp32 dQ row in
// registers, looping over 16-key tiles from key 0 to the tile's causal end.
// dK/dV runs one block per (64-key tile, b*h), one thread per key with its k
// and v rows in shared memory and its fp32 dK and dV rows in registers,
// looping over 16-row query tiles from the first tile a causal key can see
// to L.  Each loop inside a block replaces a sequential grid axis of the TPU
// kernel, and no two blocks write the same row, so no atomics are needed.
// Products are scalar fp32 FMAs, as in flash_fwd.cu.

#include "flash_common.cuh"

namespace flash {

constexpr int DQ_BQ = 64;   // query rows per dQ block, one thread each
constexpr int DQ_BK = 16;   // keys staged per dQ step
constexpr int DKV_BK = 64;  // keys per dK/dV block, one thread each
constexpr int DKV_BQ = 16;  // query rows staged per dK/dV step

template <typename T, int D>
__global__ void __launch_bounds__(DQ_BQ)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int H, int L, Strides sq, Strides sk, Strides sv,
                        Strides sdo, Strides sdq, int causal, float scale) {
  __shared__ float qs[DQ_BQ][D + 1];
  __shared__ float dos[DQ_BQ][D + 1];
  __shared__ float ks[DQ_BK][D];
  __shared__ float vs[DQ_BK][D];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * DQ_BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q_pos = q0 + tid;

  load_rows<T, D, DQ_BQ>(&qs[0][0], D + 1, q, sq, b, h, q0, L, tid, DQ_BQ);
  load_rows<T, D, DQ_BQ>(&dos[0][0], D + 1, dout, sdo, b, h, q0, L, tid, DQ_BQ);
  const float lse_r = q_pos < L ? lse[(long long)bh * L + q_pos] : -CUDART_INF_F;
  const float delta_r = q_pos < L ? delta[(long long)bh * L + q_pos] : 0.f;
  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.f;

  const int k_end = causal ? min(L, q0 + DQ_BQ) : L;
  for (int k0 = 0; k0 < k_end; k0 += DQ_BK) {
    __syncthreads();
    load_rows<T, D, DQ_BK>(&ks[0][0], D, k, sk, b, h, k0, L, tid, DQ_BQ);
    load_rows<T, D, DQ_BK>(&vs[0][0], D, v, sv, b, h, k0, L, tid, DQ_BQ);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < DQ_BK; ++j) {
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        s = fmaf(qs[tid][i], ks[j][i], s);
        dp = fmaf(dos[tid][i], vs[j][i], dp);
      }
      float p, ds;
      block_grads(s * scale, dp, lse_r, delta_r, key_live(q_pos, k0 + j, L, causal), scale, p,
                  ds);
      const float dsr = round_to<T>(ds);  // dS enters dS.K in the input type
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] = fmaf(dsr, ks[j][i], acc[i]);
    }
  }

  __syncthreads();  // reuse qs to stage dQ for coalesced stores
#pragma unroll
  for (int i = 0; i < D; ++i) qs[tid][i] = acc[i];
  __syncthreads();
  store_rows<T, D, DQ_BQ>(dq, sdq, &qs[0][0], D + 1, b, h, q0, L, tid, DQ_BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(DKV_BK)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int H, int L, Strides sq,
                         Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                         int causal, float scale) {
  __shared__ float ks[DKV_BK][D + 1];
  __shared__ float vs[DKV_BK][D + 1];
  __shared__ float qs[DKV_BQ][D];
  __shared__ float dos[DKV_BQ][D];
  __shared__ float lses[DKV_BQ];
  __shared__ float deltas[DKV_BQ];

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * DKV_BK;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k_pos = k0 + tid;

  load_rows<T, D, DKV_BK>(&ks[0][0], D + 1, k, sk, b, h, k0, L, tid, DKV_BK);
  load_rows<T, D, DKV_BK>(&vs[0][0], D + 1, v, sv, b, h, k0, L, tid, DKV_BK);
  float dka[D];
  float dva[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  // causal: a query row before this tile's first key sees none of its keys
  const int q_begin = causal ? (k0 / DKV_BQ) * DKV_BQ : 0;
  for (int q0 = q_begin; q0 < L; q0 += DKV_BQ) {
    __syncthreads();
    load_rows<T, D, DKV_BQ>(&qs[0][0], D, q, sq, b, h, q0, L, tid, DKV_BK);
    load_rows<T, D, DKV_BQ>(&dos[0][0], D, dout, sdo, b, h, q0, L, tid, DKV_BK);
    if (tid < DKV_BQ) {
      const int pos = q0 + tid;
      lses[tid] = pos < L ? lse[(long long)bh * L + pos] : -CUDART_INF_F;
      deltas[tid] = pos < L ? delta[(long long)bh * L + pos] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < DKV_BQ; ++r) {
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        s = fmaf(qs[r][i], ks[tid][i], s);
        dp = fmaf(dos[r][i], vs[tid][i], dp);
      }
      float p, ds;
      block_grads(s * scale, dp, lses[r], deltas[r], key_live(q0 + r, k_pos, L, causal), scale,
                  p, ds);
      const float pr = round_to<T>(p);    // P enters P^T.dO in the input type
      const float dsr = round_to<T>(ds);  // dS enters dS^T.Q in the input type
#pragma unroll
      for (int i = 0; i < D; ++i) {
        dva[i] = fmaf(pr, dos[r][i], dva[i]);
        dka[i] = fmaf(dsr, qs[r][i], dka[i]);
      }
    }
  }

  __syncthreads();  // each thread overwrites only its own k and v rows
#pragma unroll
  for (int i = 0; i < D; ++i) {
    ks[tid][i] = dka[i];
    vs[tid][i] = dva[i];
  }
  __syncthreads();
  store_rows<T, D, DKV_BK>(dk, sdk, &ks[0][0], D + 1, b, h, k0, L, tid, DKV_BK);
  store_rows<T, D, DKV_BK>(dv, sdv, &vs[0][0], D + 1, b, h, k0, L, tid, DKV_BK);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int H, int L,
                      const long long* st, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((L + DQ_BQ - 1) / DQ_BQ, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, DQ_BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), H, L, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                       int L, const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  const dim3 grid((L + DKV_BK - 1) / DKV_BK, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, DKV_BK, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), H, L,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), causal, scale);
  return cudaGetLastError();
}

}  // namespace flash

// dtype: 0 = fp32, 1 = bf16; D: 32 or 64.  strides: 15 int64, the (b, l, h)
// element strides of q, k, v, dO and dq.  Returns the launch's cudaError_t.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int B, int H, int L,
                            int D, int dtype, int causal, float scale, const void* strides,
                            void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && D == 32) {
    err = flash::launch_dq<float, 32>(q, k, v, dout, lse, delta, dq, B, H, L, st, causal, scale, s);
  } else if (dtype == 0 && D == 64) {
    err = flash::launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, B, H, L, st, causal, scale, s);
  } else if (dtype == 1 && D == 32) {
    err = flash::launch_dq<__nv_bfloat16, 32>(q, k, v, dout, lse, delta, dq, B, H, L, st, causal,
                                              scale, s);
  } else if (dtype == 1 && D == 64) {
    err = flash::launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, B, H, L, st, causal,
                                              scale, s);
  }
  return static_cast<int>(err);
}

// strides: 18 int64, the (b, l, h) element strides of q, k, v, dO, dk and dv.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                             int L, int D, int dtype, int causal, float scale,
                             const void* strides, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && D == 32) {
    err = flash::launch_dkv<float, 32>(q, k, v, dout, lse, delta, dk, dv, B, H, L, st, causal,
                                       scale, s);
  } else if (dtype == 0 && D == 64) {
    err = flash::launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, L, st, causal,
                                       scale, s);
  } else if (dtype == 1 && D == 32) {
    err = flash::launch_dkv<__nv_bfloat16, 32>(q, k, v, dout, lse, delta, dk, dv, B, H, L, st,
                                               causal, scale, s);
  } else if (dtype == 1 && D == 64) {
    err = flash::launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, L, st,
                                               causal, scale, s);
  }
  return static_cast<int>(err);
}
