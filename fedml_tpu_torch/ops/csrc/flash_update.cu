// Ring attention's shard fold for Hopper (sm_90a) in fp32: one K/V shard
// folded into a carried online-softmax state (m, l, unnormalised o).
//
// Replaces: fedml_tpu/ops/flash_attention.py:_flash_update_kernel (the Pallas
// TPU kernel launched by _flash_shard_update_impl) for fp32 q, k, v; bf16
// inputs take the tensor-core kernel of flash_update_sm90.cu.  Same function:
// scores = q.k^T / sqrt(D); a key is live iff k_pos >= 0 and, when causal,
// q_pos >= k_pos, with positions read from the q_pos/k_pos arrays (global
// offsets in the ring, not indices); the state seeded from (m_in, l_in, o_in)
// takes each live key by the online-softmax rescale; m, l and o are always
// written, also when no key was live (then the state passes through
// unchanged).
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores), at the sequence-parallel TransformerLM's fold (B 8, Lq = Lk 256, H
// 16, D 64): each fold moves q, k and v once, the positions, m and l in and
// out and o in and out, 42.5 MB (13 us).  A fold whose keys all lie before the
// rows does 2.15 GFLOP (4 D per live pair): 32 us at the fp32 rate, so
// operations.  The diagonal fold has half the live pairs and a dead fold none.
//
// Design: as flash_fwd.cu, one block per (64-row query tile, b*h) and one
// thread per query row, which seeds its fp32 accumulator, running max and
// denominator from the carried state and keeps its q row in registers.  A
// loop inside the block walks 32-key tiles: their positions are staged first
// and a tile with no live key for any row of the query tile (all padding, or
// when causal its first live key after the tile's last row, taken from the
// positions themselves since they need not be sorted) is skipped before its
// K and V are read, which stands in for the TPU kernel's dead-block skip.  A
// live tile's K and V are staged in shared memory and folded 16 keys at a
// time with scalar fp32 FMAs (never TF32).  The ragged edges of q and k are masked here, so nothing is padded outside.

#include <climits>

#include "flash_common.cuh"

namespace flash {

constexpr int UPD_BQ = 64;  // query rows per block, one thread each
constexpr int UPD_BK = 32;  // keys staged in shared memory per step
constexpr int UPD_KC = 16;  // keys folded into the online softmax at once

template <int D>
__global__ void __launch_bounds__(UPD_BQ)
    flash_update_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ q_pos,
                        const int* __restrict__ k_pos, const float* __restrict__ m_in,
                        const float* __restrict__ l_in, const float* __restrict__ o_in,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ o_out, int H, int Lq, int Lk, Strides sq,
                        Strides sk, Strides sv, Strides soi, Strides soo, int causal,
                        float scale) {
  __shared__ float qs[UPD_BQ][D + 1];  // +1: a thread's own row is bank-conflict free
  __shared__ float ks[UPD_BK][D];
  __shared__ float vs[UPD_BK][D];
  __shared__ int kps[UPD_BK];
  __shared__ int q_last;  // the latest position among the tile's rows

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * UPD_BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row = q0 + tid;
  const bool in_range = row < Lq;
  const int qp = in_range ? q_pos[row] : INT_MIN;  // a row past Lq sees no key when causal

  if (tid == 0) q_last = INT_MIN;
  load_rows<D, UPD_BQ>(&qs[0][0], D + 1, q, sq, b, h, q0, Lq, tid, UPD_BQ);
  __syncthreads();
  atomicMax(&q_last, qp);
  float qr[D];
#pragma unroll
  for (int i = 0; i < D; ++i) qr[i] = qs[tid][i];
  __syncthreads();  // q is in registers: stage the carried accumulator
  load_rows<D, UPD_BQ>(&qs[0][0], D + 1, o_in, soi, b, h, q0, Lq, tid, UPD_BQ);
  __syncthreads();
  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = qs[tid][i];
  const long long state = (long long)bh * Lq + row;
  float m = in_range ? m_in[state] : -CUDART_INF_F;
  float l = in_range ? l_in[state] : 0.f;
  const int tile_last = q_last;

  for (int k0 = 0; k0 < Lk; k0 += UPD_BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < UPD_BK; e += UPD_BQ) kps[e] = k0 + e < Lk ? k_pos[k0 + e] : -1;
    __syncthreads();
    // dead-tile skip, the same decision on every thread of the block
    int first_live = INT_MAX;
#pragma unroll 8
    for (int j = 0; j < UPD_BK; ++j) {
      if (kps[j] >= 0) first_live = min(first_live, kps[j]);
    }
    if (first_live == INT_MAX || (causal && tile_last < first_live)) continue;
    load_rows<D, UPD_BK>(&ks[0][0], D, k, sk, b, h, k0, Lk, tid, UPD_BQ);
    load_rows<D, UPD_BK>(&vs[0][0], D, v, sv, b, h, k0, Lk, tid, UPD_BQ);
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < UPD_BK; c += UPD_KC) {
      float s[UPD_KC];
      float cmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < UPD_KC; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) dot = fmaf(qr[i], ks[c + j][i], dot);
        s[j] = key_live_at(qp, kps[c + j], causal) ? dot * scale : -CUDART_INF_F;
        cmax = fmaxf(cmax, s[j]);
      }
      float safe_m;
      const float corr = online_rescale(m, cmax, safe_m);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < UPD_KC; ++j) {
        s[j] = is_finite(s[j]) ? expf(s[j] - safe_m) : 0.f;  // P
        psum += s[j];
      }
      l = l * corr + psum;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float a = acc[i] * corr;
#pragma unroll
        for (int j = 0; j < UPD_KC; ++j) a = fmaf(s[j], vs[c + j][i], a);
        acc[i] = a;
      }
    }
  }

  // the state is written whatever happened, as the TPU kernel's _finish does
  __syncthreads();  // reuse qs to stage o for coalesced stores
#pragma unroll
  for (int i = 0; i < D; ++i) qs[tid][i] = acc[i];
  if (in_range) {
    m_out[state] = m;
    l_out[state] = l;
  }
  __syncthreads();
  store_rows<D, UPD_BQ>(o_out, soo, &qs[0][0], D + 1, b, h, q0, Lq, tid, UPD_BQ);
}

template <int D>
cudaError_t launch_update(const void* q, const void* k, const void* v, const void* q_pos,
                          const void* k_pos, const void* m_in, const void* l_in,
                          const void* o_in, void* m_out, void* l_out, void* o_out, int B, int H,
                          int Lq, int Lk, const long long* st, int causal, float scale,
                          cudaStream_t stream) {
  const dim3 grid((Lq + UPD_BQ - 1) / UPD_BQ, B * H);
  flash_update_kernel<D><<<grid, UPD_BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
      static_cast<const float*>(m_in), static_cast<const float*>(l_in),
      static_cast<const float*>(o_in), static_cast<float*>(m_out), static_cast<float*>(l_out),
      static_cast<float*>(o_out), H, Lq, Lk, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), causal, scale);
  return cudaGetLastError();
}

}  // namespace flash

// fp32 only; D: 32 or 64.  q_pos [Lq] and k_pos [Lk] are int32; m_in, l_in,
// m_out, l_out contiguous fp32 [B, H, Lq]; o_in, o_out fp32 [B, Lq, H, D].
// strides: 15 int64, the (b, l, h) element strides of q, k, v, o_in and
// o_out.  Returns the launch's cudaError_t.
extern "C" int flash_update(const void* q, const void* k, const void* v, const void* q_pos,
                            const void* k_pos, const void* m_in, const void* l_in,
                            const void* o_in, void* m_out, void* l_out, void* o_out, int B,
                            int H, int Lq, int Lk, int D, int causal, float scale,
                            const void* strides, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 32) {
    err = flash::launch_update<32>(q, k, v, q_pos, k_pos, m_in, l_in, o_in, m_out, l_out, o_out,
                                   B, H, Lq, Lk, st, causal, scale, s);
  } else if (D == 64) {
    err = flash::launch_update<64>(q, k, v, q_pos, k_pos, m_in, l_in, o_in, m_out, l_out, o_out,
                                   B, H, Lq, Lk, st, causal, scale, s);
  }
  return static_cast<int>(err);
}
