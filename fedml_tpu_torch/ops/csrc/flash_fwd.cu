// Flash-attention forward for Hopper (sm_90a): O and the per-row LSE.
//
// Replaces: fedml_tpu/ops/flash_attention.py:_flash_kernel (the Pallas TPU
// kernel launched by _flash_forward).  Same function: scores = q.k^T / sqrt(D)
// with keys at or past L masked and, when causal, keys after the row masked;
// online softmax in fp32; O = softmax . V in the input type; LSE in fp32
// (-inf for a row with no live key).
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores, 989 TFLOP/s bf16 dense):
// - the slice's shape (B 32, L 80, H 8, D 32, fp32, causal): 10.6 MB moved
//   (q, k, v read once, O and LSE written once) against 0.11 GFLOP, so bytes:
//   about 3 us, below a launch's own overhead;
// - L 1024 (B 8, H 16, D 64, causal): 17.2 GFLOP.  In fp32 that is 256 us at
//   the fp32 rate against 40 us for its 134 MB, so operations; in bf16 it is
//   17 us at the tensor-core peak against 20 us for its 67 MB, so the two
//   bounds meet there.
//
// Design: one block per (64-row query tile, b*h) and one thread per query
// row, which keeps its q row, its fp32 accumulator and the running max and
// denominator in registers.  A loop inside the block walks 32-key tiles of K
// and V staged in shared memory (all threads read the same key: a broadcast),
// folding 16 keys at a time into the online softmax.  The causal loop ends at
// the tile's last row, which stands in for the TPU kernel's dead-block skip.
// The ragged edge is masked in the kernel, so nothing is padded or transposed
// outside it.  Products are scalar fp32 FMAs (exact for bf16 inputs), not
// tensor-core MMAs: this first kernel is right and simple, and the L-1024
// case is held to the fp32 rate until a wgmma version replaces it.

#include "flash_common.cuh"

namespace flash {

constexpr int FWD_BQ = 64;  // query rows per block, one thread each
constexpr int FWD_BK = 32;  // keys staged in shared memory per step
constexpr int FWD_KC = 16;  // keys folded into the online softmax at once

template <typename T, int D>
__global__ void __launch_bounds__(FWD_BQ)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int H, int L, Strides sq,
                     Strides sk, Strides sv, Strides so, int causal, float scale) {
  __shared__ float qs[FWD_BQ][D + 1];  // +1: a thread's own row is bank-conflict free
  __shared__ float ks[FWD_BK][D];
  __shared__ float vs[FWD_BK][D];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * FWD_BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q_pos = q0 + tid;

  load_rows<T, D, FWD_BQ>(&qs[0][0], D + 1, q, sq, b, h, q0, L, tid, FWD_BQ);
  __syncthreads();
  float qr[D];
  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] = qs[tid][i];
    acc[i] = 0.f;
  }
  float m = -CUDART_INF_F;
  float l = 0.f;

  // no row of this tile attends a key after its last row
  const int k_end = causal ? min(L, q0 + FWD_BQ) : L;
  for (int k0 = 0; k0 < k_end; k0 += FWD_BK) {
    __syncthreads();  // the previous tile is consumed
    load_rows<T, D, FWD_BK>(&ks[0][0], D, k, sk, b, h, k0, L, tid, FWD_BQ);
    load_rows<T, D, FWD_BK>(&vs[0][0], D, v, sv, b, h, k0, L, tid, FWD_BQ);
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < FWD_BK; c += FWD_KC) {
      float s[FWD_KC];
      float cmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < FWD_KC; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) dot = fmaf(qr[i], ks[c + j][i], dot);
        s[j] = key_live(q_pos, k0 + c + j, L, causal) ? dot * scale : -CUDART_INF_F;
        cmax = fmaxf(cmax, s[j]);
      }
      float safe_m;
      const float corr = online_rescale(m, cmax, safe_m);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < FWD_KC; ++j) {
        const float p = is_finite(s[j]) ? expf(s[j] - safe_m) : 0.f;
        psum += p;
        s[j] = round_to<T>(p);  // P enters P.V in the input type
      }
      l = l * corr + psum;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float a = acc[i] * corr;
#pragma unroll
        for (int j = 0; j < FWD_KC; ++j) a = fmaf(s[j], vs[c + j][i], a);
        acc[i] = a;
      }
    }
  }

  const float denom = fmaxf(l, 1e-20f);
  __syncthreads();  // reuse qs to stage O for coalesced stores
#pragma unroll
  for (int i = 0; i < D; ++i) qs[tid][i] = acc[i] / denom;
  if (q_pos < L) lse[(long long)bh * L + q_pos] = row_lse(m, l);
  __syncthreads();
  store_rows<T, D, FWD_BQ>(o, so, &qs[0][0], D + 1, b, h, q0, L, tid, FWD_BQ);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int H, int L, const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  const dim3 grid((L + FWD_BQ - 1) / FWD_BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, FWD_BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, L, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), causal, scale);
  return cudaGetLastError();
}

}  // namespace flash

// dtype: 0 = fp32, 1 = bf16; D: 32 or 64.  strides: 12 int64, the (b, l, h)
// element strides of q, k, v and o.  Returns the launch's cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                         int H, int L, int D, int dtype, int causal, float scale,
                         const void* strides, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && D == 32) {
    err = flash::launch_fwd<float, 32>(q, k, v, o, lse, B, H, L, st, causal, scale, s);
  } else if (dtype == 0 && D == 64) {
    err = flash::launch_fwd<float, 64>(q, k, v, o, lse, B, H, L, st, causal, scale, s);
  } else if (dtype == 1 && D == 32) {
    err = flash::launch_fwd<__nv_bfloat16, 32>(q, k, v, o, lse, B, H, L, st, causal, scale, s);
  } else if (dtype == 1 && D == 64) {
    err = flash::launch_fwd<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, L, st, causal, scale, s);
  }
  return static_cast<int>(err);
}
