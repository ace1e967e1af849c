// Flash-attention backward for Hopper (sm_90a) in fp32: dQ, and dK with dV.
//
// Replaces: fedml_tpu/ops/flash_attention.py:_flash_bwd_dq_kernel and
// fedml_tpu/ops/flash_attention.py:_flash_bwd_dkv_kernel (the two Pallas TPU
// kernels launched by _flash_backward) for fp32 inputs; bf16 inputs take the
// tensor-core kernels of flash_dq_sm90.cu and flash_dkv_sm90.cu.  All of them
// rebuild P from (q, k, lse) and form dS = P * (dO.V^T - delta) * scale
// through the one block_grads of flash_common.cuh, so the gradients cannot
// drift apart; delta = rowsum(dO * O) comes in precomputed, as in the JAX
// package.
//   dQ = sum over keys of dS . K
//   dV = sum over queries of P^T . dO,  dK = sum over queries of dS^T . Q
//
// What bounds them on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores):
// - the slice's shape (B 32, L 80, H 8, D 32, causal): dQ moves 13.3 MB for
//   0.16 GFLOP, dK/dV 15.9 MB for 0.21 GFLOP, so bytes: 4 and 5 us;
// - L 1024 (B 8, H 16, D 64, causal): dQ does 25.8 GFLOP and dK/dV 34.4
//   GFLOP, 385 and 513 us at the fp32 rate against 50 and 60 us of bytes, so
//   operations.
//
// Design: dQ runs one block per (64-row query tile, b*h) with two threads per
// query row, each holding half of the row's q, dO and fp32 dQ in registers
// (columns interleaved in runs of 4, so a thread reads a staged key row 16
// bytes at a time), and loops over 16-key tiles from key 0 to the tile's
// causal end.  dK/dV runs one block per (64-key tile, b*h) with two threads
// per key, each holding half of the key's dK and dV rows (the even or the odd
// elements), and loops over 16-row query tiles from the first tile a causal
// key can see to L.  Half rows keep ptxas from spilling at D 64.  A pair
// splits each dot product (q.k and dO.v) and joins the halves with one
// shuffle.  Each loop inside a block replaces a
// sequential grid axis of the TPU kernel, and no two blocks write the same
// row, so no atomics are needed.  Products are scalar fp32 FMAs, never TF32.

#include "flash_common.cuh"

namespace flash {

constexpr int DQ_BQ = 64;              // query rows per dQ block
constexpr int DQ_THREADS = 2 * DQ_BQ;  // two threads per row
constexpr int DQ_BK = 16;              // keys staged per dQ step
constexpr int DKV_BK = 64;            // keys per dK/dV block
constexpr int DKV_THREADS = 2 * DKV_BK;  // two threads per key
constexpr int DKV_BQ = 16;            // query rows staged per dK/dV step

// Column of element i of a dQ thread's half row: the pair's halves interleave
// in runs of 4 (half 0 holds columns 0-3, 8-11, ...; half 1 holds 4-7, 12-15,
// ...), so each thread reads a key row 16 bytes at a time and the pair's two
// reads fall in different banks.
__device__ __forceinline__ int dq_col(int i, int half) {
  return 8 * (i / 4) + 4 * half + i % 4;
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int L, Strides sq, Strides sk, Strides sv,
                        Strides sdo, Strides sdq, int causal, float scale) {
  constexpr int HALF = D / 2;  // elements of a row held by each thread of a pair
  __shared__ float qs[DQ_BQ][D + 1];  // q, then dQ, staged for coalesced rows
  __shared__ float dos[DQ_BQ][D + 1];
  __shared__ __align__(16) float ks[DQ_BK][D];
  __shared__ __align__(16) float vs[DQ_BK][D];

  const int tid = threadIdx.x;
  const int row = tid >> 1;  // this thread's query row in the tile
  const int half = tid & 1;  // and its half of the row (dq_col)
  const int q0 = blockIdx.x * DQ_BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q_pos = q0 + row;

  load_rows<D, DQ_BQ>(&qs[0][0], D + 1, q, sq, b, h, q0, L, tid, DQ_THREADS);
  load_rows<D, DQ_BQ>(&dos[0][0], D + 1, dout, sdo, b, h, q0, L, tid, DQ_THREADS);
  const float lse_r = q_pos < L ? lse[(long long)bh * L + q_pos] : -CUDART_INF_F;
  const float delta_r = q_pos < L ? delta[(long long)bh * L + q_pos] : 0.f;
  __syncthreads();
  float qr[HALF], dor[HALF], acc[HALF];  // this thread's half of q, dO and dQ
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    qr[i] = qs[row][dq_col(i, half)];
    dor[i] = dos[row][dq_col(i, half)];
    acc[i] = 0.f;
  }

  const int k_end = causal ? min(L, q0 + DQ_BQ) : L;
  for (int k0 = 0; k0 < k_end; k0 += DQ_BK) {
    __syncthreads();
    load_rows<D, DQ_BK>(&ks[0][0], D, k, sk, b, h, k0, L, tid, DQ_THREADS);
    load_rows<D, DQ_BK>(&vs[0][0], D, v, sv, b, h, k0, L, tid, DQ_THREADS);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < DQ_BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][4 * half]);
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][4 * half]);
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < HALF; i += 4) {
        const float4 kk = kr[i / 2];  // columns dq_col(i .. i + 3, half)
        const float4 vv = vr[i / 2];
        s = fmaf(qr[i], kk.x, s);
        s = fmaf(qr[i + 1], kk.y, s);
        s = fmaf(qr[i + 2], kk.z, s);
        s = fmaf(qr[i + 3], kk.w, s);
        dp = fmaf(dor[i], vv.x, dp);
        dp = fmaf(dor[i + 1], vv.y, dp);
        dp = fmaf(dor[i + 2], vv.z, dp);
        dp = fmaf(dor[i + 3], vv.w, dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);  // the pair's two halves
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      float p, ds;
      block_grads(s * scale, dp, lse_r, delta_r, key_live(q_pos, k0 + j, L, causal), scale, p,
                  ds);
#pragma unroll
      for (int i = 0; i < HALF; i += 4) {
        const float4 kk = kr[i / 2];
        acc[i] = fmaf(ds, kk.x, acc[i]);
        acc[i + 1] = fmaf(ds, kk.y, acc[i + 1]);
        acc[i + 2] = fmaf(ds, kk.z, acc[i + 2]);
        acc[i + 3] = fmaf(ds, kk.w, acc[i + 3]);
      }
    }
  }

  __syncthreads();  // each pair overwrites only its own q row
#pragma unroll
  for (int i = 0; i < HALF; ++i) qs[row][dq_col(i, half)] = acc[i];
  __syncthreads();
  store_rows<D, DQ_BQ>(dq, sdq, &qs[0][0], D + 1, b, h, q0, L, tid, DQ_THREADS);
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int L,
                         Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, int causal, float scale) {
  constexpr int HALF = D / 2;  // elements of a row held by each thread of a pair
  // pitch D + 2: the 16 pairs of a warp read 32 distinct banks
  __shared__ float ks[DKV_BK][D + 2];
  __shared__ float vs[DKV_BK][D + 2];
  __shared__ float qs[DKV_BQ][D];
  __shared__ float dos[DKV_BQ][D];
  __shared__ float lses[DKV_BQ];
  __shared__ float deltas[DKV_BQ];

  const int tid = threadIdx.x;
  const int key = tid >> 1;   // this thread's key in the tile
  const int half = tid & 1;   // and its elements of the row: half, half + 2, ...
  const int k0 = blockIdx.x * DKV_BK;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k_pos = k0 + key;

  load_rows<D, DKV_BK>(&ks[0][0], D + 2, k, sk, b, h, k0, L, tid, DKV_THREADS);
  load_rows<D, DKV_BK>(&vs[0][0], D + 2, v, sv, b, h, k0, L, tid, DKV_THREADS);
  float dka[HALF];
  float dva[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  // causal: a query row before this tile's first key sees none of its keys
  const int q_begin = causal ? (k0 / DKV_BQ) * DKV_BQ : 0;
  for (int q0 = q_begin; q0 < L; q0 += DKV_BQ) {
    __syncthreads();
    load_rows<D, DKV_BQ>(&qs[0][0], D, q, sq, b, h, q0, L, tid, DKV_THREADS);
    load_rows<D, DKV_BQ>(&dos[0][0], D, dout, sdo, b, h, q0, L, tid, DKV_THREADS);
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
      for (int i = 0; i < HALF; ++i) {
        const int c = 2 * i + half;
        s = fmaf(qs[r][c], ks[key][c], s);
        dp = fmaf(dos[r][c], vs[key][c], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);  // the pair's two halves
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      float p, ds;
      block_grads(s * scale, dp, lses[r], deltas[r], key_live(q0 + r, k_pos, L, causal), scale,
                  p, ds);
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const int c = 2 * i + half;
        dva[i] = fmaf(p, dos[r][c], dva[i]);
        dka[i] = fmaf(ds, qs[r][c], dka[i]);
      }
    }
  }

  __syncthreads();  // each pair overwrites only its own k and v rows
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    ks[key][2 * i + half] = dka[i];
    vs[key][2 * i + half] = dva[i];
  }
  __syncthreads();
  store_rows<D, DKV_BK>(dk, sdk, &ks[0][0], D + 2, b, h, k0, L, tid, DKV_THREADS);
  store_rows<D, DKV_BK>(dv, sdv, &vs[0][0], D + 2, b, h, k0, L, tid, DKV_THREADS);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int H, int L,
                      const long long* st, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((L + DQ_BQ - 1) / DQ_BQ, B * H);
  flash_bwd_dq_kernel<D><<<grid, DQ_THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), H, L, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                       int L, const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  const dim3 grid((L + DKV_BK - 1) / DKV_BK, B * H);
  flash_bwd_dkv_kernel<D><<<grid, DKV_THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), H, L,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), causal, scale);
  return cudaGetLastError();
}

}  // namespace flash

// fp32 only; D: 32 or 64.  strides: 15 int64, the (b, l, h) element strides of
// q, k, v, dO and dq.  Returns the launch's cudaError_t.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int B, int H, int L,
                            int D, int causal, float scale, const void* strides, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 32) {
    err = flash::launch_dq<32>(q, k, v, dout, lse, delta, dq, B, H, L, st, causal, scale, s);
  } else if (D == 64) {
    err = flash::launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, L, st, causal, scale, s);
  }
  return static_cast<int>(err);
}

// fp32 only; D: 32 or 64.  strides: 18 int64, the (b, l, h) element strides of
// q, k, v, dO, dk and dv.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                             int L, int D, int causal, float scale, const void* strides,
                             void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 32) {
    err = flash::launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, B, H, L, st, causal, scale, s);
  } else if (D == 64) {
    err = flash::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, L, st, causal, scale, s);
  }
  return static_cast<int>(err);
}
