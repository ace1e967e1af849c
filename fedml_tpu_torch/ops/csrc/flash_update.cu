// Ring attention's shard fold for Hopper (sm_90a) in fp32: one K/V shard
// folded into a carried online-softmax state (m, l, unnormalised o), every
// product on the tensor cores in split TF32.
//
// Replaces: fedml_tpu/ops/flash_attention.py:_flash_update_kernel (the Pallas
// TPU kernel launched by _flash_shard_update_impl) for fp32 q, k, v; bf16
// inputs take the tensor-core kernel of flash_update_sm90.cu.  Same function:
// scores = q.k^T / sqrt(D); a key is live iff k_pos >= 0 and, when causal,
// q_pos >= k_pos, with positions read from the q_pos/k_pos arrays (global
// offsets in the ring, not indices, and not necessarily sorted); the state
// seeded from (m_in, l_in, o_in) takes each live key by the online-softmax
// rescale, a row with no live key so far keeping m = -inf and a correction of
// 0; m, l and the unnormalised o are always written, with no division by l,
// so a fold with no live key for a row passes that row through bit for bit.
//
// Products.  As in flash_fwd.cu: mma.sync m16n8k8 TF32, each fp32 operand
// split into a TF32 big part and the small remainder, three TF32 products
// summed in fp32 (flash_tf32.cuh, shared with the forward and backward).  The
// exponentials are exp2 of log2(e)-scaled scores; m stays in natural units
// (the max of q.k / sqrt(D)), as it comes in and goes out, and only the
// shift is scaled: p = 2^(s log2(e) - m log2(e)).
//
// What bounds it on an H100 (3.35 TB/s; fp32-exact products at the 3xTF32
// rate, 495 / 3 = 165 TFLOP/s), at the sequence-parallel TransformerLM's fold
// (B 8, Lq = Lk 256, H 16, D 64): a fold whose keys all lie before the rows
// moves q, k and v once, the positions, m and l in and out and o in and out,
// 42.5 MB (12.7 us), and does 2.15 GFLOP (4 D per live pair), 13.0 us:
// operations, by a hair.  The diagonal fold has about half the live pairs, so
// bytes bound it (12.7 us); a dead fold needs no q, k or v, only the state,
// 17.3 MB (5.2 us).
//
// Design: a warp owns 16 query rows and a block 4 warps (64 rows) of one
// (b, h), the last q tile first (the ring's positions ascend, so it has the
// most live keys).  Before any q, k or v byte is read, the block reads the Lk
// key positions and records, for each key tile, its least live position; it
// keeps the live tiles in order, a tile being dead when it has no live key or,
// when causal, its least live position lies after the q tile's latest row
// position (the TPU kernel's dead-block skip; it holds for unsorted
// positions).  A dead fold so reads only the state.  The live tiles alone stream,
// each with its key positions, through a 2-stage ring of 16-byte cp.async
// copies (keys past Lk zero-filled and read as position -1); K rows are padded
// to D + 8 floats and V rows to D + 4, so every fragment load is free of bank
// conflicts.  The Q tile lands with the first live tile and stays in shared
// memory: a warp reads its Q fragments at each 8-deep step of S and splits them
// there, which keeps the kernel at 128 registers, 4 blocks an SM, so that the
// sp fold's 512 blocks run in one wave (Q held split in registers took 167
// registers, 3 blocks an SM).  The carried state seeds the registers: each row's
// m, its l on the quad's first thread (the quad's sum gives l_in back exactly),
// and o_in straight into the 16 x D accumulator fragment, 8 bytes a thread.  Per
// live tile, as in flash_fwd.cu, S = Q.K^T, each score's live test on the
// positions (key_live_at; the forward's index shortcuts do not hold for
// positions out of order), the online softmax on the fragment from the carried
// max (row max and sum over the quad by shuffles), and o += P.V with P kept in
// registers in the permuted key order.  m, l and o of every row inside Lq go out
// from registers, o 8 bytes a thread.  Rows past Lq are neither read as live nor
// written, and nothing is padded outside the kernel.  The wrapper raises on q,
// k, v that 16-byte copies cannot load and on an o_in that 8-byte loads cannot.

#include <climits>

#include "flash_tf32.cuh"

namespace flash {
namespace tf32 {

constexpr int BQ = 16 * WARPS;  // query rows per block

// keys per K/V tile: 32 at D 64, 64 at D 32 (the same bytes a tile)
template <int D>
struct FoldTile {
  static constexpr int BK = D == 64 ? 32 : 64;
  static constexpr int LDQ = D + 8;  // Q and K: 8-byte fragment loads, conflict free
  static constexpr int LDK = D + 8;
  static constexpr int LDV = D + 4;  // V: 4-byte loads two keys apart, conflict free
  static constexpr int Q = 0;                         // 4-byte offsets in shared memory
  static constexpr int K = BQ * LDQ;                  // stage s at K + s * BK * LDK
  static constexpr int V = K + STAGES * BK * LDK;     // stage s at V + s * BK * LDV
  static constexpr int KPOS = V + STAGES * BK * LDV;  // int key positions, stage s at + s * BK
  static constexpr int WORDS = KPOS + STAGES * BK;    // then one int a key tile
};

template <int D>
__global__ void __launch_bounds__(THREADS, 4)
    flash_update_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ q_pos,
                        const int* __restrict__ k_pos, const float* __restrict__ m_in,
                        const float* __restrict__ l_in, const float* __restrict__ o_in,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ o_out, int H, int Lq, int Lk, Strides sq,
                        Strides sk, Strides sv, Strides soi, Strides soo, int causal,
                        float scale) {
  using T = FoldTile<D>;
  constexpr int BK = T::BK;
  constexpr int NT = BK / 8;  // 8-key column tiles of S
  constexpr int KD = D / 8;   // 8-deep steps of S; 8-column tiles of o
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* kpos = reinterpret_cast<int*>(smem + T::KPOS);
  const int n_kt = (Lk + BK - 1) / BK;
  // each key tile's least live position (INT_MAX: none), then the list of
  // live tiles, written over it
  int* tiles = reinterpret_cast<int*>(smem + T::WORDS);
  __shared__ int warp_last[WARPS];  // each warp's latest row position
  __shared__ int n_live;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the latest positions first
  const int r0 = q0 + 16 * warp;                      // this warp's first row
  const bool rows = r0 < Lq;                          // the warp has a row inside Lq

  // the least live position of each key tile, a warp a tile
  for (int kt = warp; kt < n_kt; kt += WARPS) {
    int least = INT_MAX;
#pragma unroll
    for (int i = 0; i < BK / 32; ++i) {
      const int key = kt * BK + 32 * i + lane;
      const int kp = key < Lk ? k_pos[key] : -1;
      if (kp >= 0) least = min(least, kp);
    }
    least = __reduce_min_sync(0xffffffffu, least);
    if (lane == 0) tiles[kt] = least;
  }

  // seed the state of this thread's two rows (r = 0: row g, 1: row g + 8)
  int qp[2];
  float m[2], l[2];  // l: this thread's share of the row's denominator
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const bool in = row < Lq;
    const long long state = (long long)bh * Lq + row;
    qp[r] = in ? q_pos[row] : INT_MIN;  // a row past Lq sees no key when causal
    m[r] = in ? m_in[state] : -CUDART_INF_F;
    l[r] = in && t == 0 ? l_in[state] : 0.f;
  }
  const int last = __reduce_max_sync(0xffffffffu, max(qp[0], qp[1]));
  if (lane == 0) warp_last[warp] = last;
  float acc[KD][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const float* orow =
        o_in + (long long)b * soi.b + (long long)row * soi.l + (long long)h * soi.h + 2 * t;
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      const float2 val = row < Lq ? *reinterpret_cast<const float2*>(orow + 8 * j)
                                  : make_float2(0.f, 0.f);
      acc[j][2 * r] = val.x;
      acc[j][2 * r + 1] = val.y;
    }
  }
  __syncthreads();  // the tiles' positions and the warps' latest rows are published

  // keep the live tiles, in order: warp 0, 32 tiles a step
  if (warp == 0) {
    int q_last = INT_MIN;  // the q tile's latest row position
#pragma unroll
    for (int w = 0; w < WARPS; ++w) q_last = max(q_last, warp_last[w]);
    int n = 0;
    for (int base = 0; base < n_kt; base += 32) {
      const int kt = base + lane;
      const int least = kt < n_kt ? tiles[kt] : INT_MAX;
      const bool keep = least != INT_MAX && (!causal || least <= q_last);
      // every lane has read its tile before any entry is overwritten
      const unsigned kept = __ballot_sync(0xffffffffu, keep);
      if (keep) tiles[n + __popc(kept & ((1u << lane) - 1u))] = kt;
      n += __popc(kept);
    }
    if (lane == 0) n_live = n;
  }
  __syncthreads();
  const int n_it = n_live;

  // queue live tile it's K, V and key positions into a stage of the ring
  auto load_kv = [&](int it, int stage) {
    const int k0 = tiles[it] * BK;
    load_tile<D, BK>(smem + T::K + stage * BK * T::LDK, T::LDK, k, sk, b, h, k0, Lk);
    load_tile<D, BK>(smem + T::V + stage * BK * T::LDV, T::LDV, v, sv, b, h, k0, Lk);
    for (int i = threadIdx.x; i < BK; i += THREADS) {
      kpos[stage * BK + i] = k0 + i < Lk ? k_pos[k0 + i] : -1;
    }
  };

  // Q lands with the first live tile; a dead fold reads no Q
  if (n_it > 0) {
    load_tile<D, BQ>(smem + T::Q, T::LDQ, q, sq, b, h, q0, Lq);
    cp_async_commit();
    load_kv(0, 0);
    cp_async_commit();
    cp_async_wait<1>();  // Q has landed
    __syncthreads();
  }

  for (int it = 0; it < n_it; ++it) {
    const int stage = it % STAGES;
    if (it + 1 < n_it) {  // the next live tile's copies overlap this tile's products
      load_kv(it + 1, (it + 1) % STAGES);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // live tile it has landed for every thread

    if (rows) {
      const float* ks = smem + T::K + stage * BK * T::LDK;
      const float* vs = smem + T::V + stage * BK * T::LDV;
      // S = Q . K^T, depth outer so that the column tiles' sums interleave;
      // Q's fragments split at each step
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
      const float* kr = ks + g * T::LDK + 2 * t;
      const float* qr = smem + T::Q + (16 * warp + g) * T::LDQ + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qb[4], qs[4];
        const float2 lo = *reinterpret_cast<const float2*>(qr + 8 * kk);
        const float2 hi = *reinterpret_cast<const float2*>(qr + 8 * T::LDQ + 8 * kk);
        split(lo.x, qb[0], qs[0]);
        split(hi.x, qb[1], qs[1]);
        split(lo.y, qb[2], qs[2]);
        split(hi.y, qb[3], qs[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(kr + 8 * j * T::LDK + 8 * kk);
          mma_3xtf32(s[j], qb, qs, kv.x, kv.y);
        }
      }
      // online softmax over this tile, from the carried max
      const int* kp = kpos + stage * BK + 2 * t;
      float cmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (!key_live_at(qp[e >> 1], kp[8 * j + (e & 1)], causal)) {
            x = -CUDART_INF_F;
          }
          s[j][e] = x;
          cmax[e >> 1] = fmaxf(cmax[e >> 1], x);
        }
      }
      float shift[2];  // safe_m * log2(e): p = 2^(s * log2(e) - shift)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float safe_m;
        const float corr = online_rescale(m[r], quad_max(cmax[r]), safe_m);
        shift[r] = safe_m * LOG2E;
        l[r] *= corr;
#pragma unroll
        for (int j = 0; j < KD; ++j) {
          acc[j][2 * r] *= corr;
          acc[j][2 * r + 1] *= corr;
        }
      }
      // P, then o += P . V
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t pb[4], ps[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[kk][e], LOG2E, -shift[e >> 1]));  // dead: 2^-inf = 0
          l[e >> 1] += p;
          // accumulator (e) -> A operand: e 0, 1, 2, 3 -> a0, a2, a1, a3
          const int a = ((e & 1) << 1) | (e >> 1);
          split(p, pb[a], ps[a]);
        }
        const float* vr = vs + (8 * kk + 2 * t) * T::LDV + g;
#pragma unroll
        for (int j = 0; j < KD; ++j) mma_3xtf32(acc[j], pb, ps, vr[8 * j], vr[T::LDV + 8 * j]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // the state is written whatever happened, as the TPU kernel's _finish does
  if (!rows) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    const int row = r0 + g + 8 * r;
    if (row < Lq) {
      const long long state = (long long)bh * Lq + row;
      if (t == 0) {
        m_out[state] = m[r];
        l_out[state] = l[r];
      }
      float* orow =
          o_out + (long long)b * soo.b + (long long)row * soo.l + (long long)h * soo.h + 2 * t;
#pragma unroll
      for (int j = 0; j < KD; ++j) {
        *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
}

template <int D>
cudaError_t launch_update(const void* q, const void* k, const void* v, const void* q_pos,
                          const void* k_pos, const void* m_in, const void* l_in,
                          const void* o_in, void* m_out, void* l_out, void* o_out, int B, int H,
                          int Lq, int Lk, const long long* st, int causal, float scale,
                          cudaStream_t stream) {
  using T = FoldTile<D>;
  const int n_kt = (Lk + T::BK - 1) / T::BK;
  const int smem = 4 * (T::WORDS + n_kt);
  const auto kernel = flash_update_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
      static_cast<const float*>(m_in), static_cast<const float*>(l_in),
      static_cast<const float*>(o_in), static_cast<float*>(m_out), static_cast<float*>(l_out),
      static_cast<float*>(o_out), H, Lq, Lk, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), causal, scale);
  return cudaGetLastError();
}

}  // namespace tf32
}  // namespace flash

// fp32 only; D: 32 or 64.  q_pos [Lq] and k_pos [Lk] are int32; m_in, l_in,
// m_out, l_out contiguous fp32 [B, H, Lq]; o_in, o_out fp32 [B, Lq, H, D].
// strides: 15 int64, the (b, l, h) element strides of q, k, v, o_in and
// o_out; q, k and v each with a 16-byte aligned base and strides that are
// multiples of 4 (16-byte copies), o_in and o_out 8-byte aligned with even
// strides.  Returns the launch's cudaError_t.
extern "C" int flash_update(const void* q, const void* k, const void* v, const void* q_pos,
                            const void* k_pos, const void* m_in, const void* l_in,
                            const void* o_in, void* m_out, void* l_out, void* o_out, int B,
                            int H, int Lq, int Lk, int D, int causal, float scale,
                            const void* strides, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 32) {
    err = flash::tf32::launch_update<32>(q, k, v, q_pos, k_pos, m_in, l_in, o_in, m_out, l_out,
                                         o_out, B, H, Lq, Lk, st, causal, scale, s);
  } else if (D == 64) {
    err = flash::tf32::launch_update<64>(q, k, v, q_pos, k_pos, m_in, l_in, o_in, m_out, l_out,
                                         o_out, B, H, Lq, Lk, st, causal, scale, s);
  }
  return static_cast<int>(err);
}
