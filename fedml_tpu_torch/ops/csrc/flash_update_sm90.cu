// Ring attention's shard fold for Hopper (sm_90a), bf16, on the tensor cores:
// one K/V shard folded into a carried online-softmax state (m, l,
// unnormalised o).
//
// Replaces: fedml_tpu/ops/flash_attention.py:_flash_update_kernel (the Pallas
// TPU kernel launched by _flash_shard_update_impl) for bf16 q, k, v; fp32
// inputs take flash_update.cu's split-TF32 kernel.  Same function as that
// kernel and flash_shard_update_plain: scores = q.k^T / sqrt(D) as fp32 sums
// of exact bf16 products; a key is live iff k_pos >= 0 and, when causal,
// q_pos >= k_pos, with positions read from the q_pos/k_pos arrays (global
// offsets in the ring, not indices, and not necessarily sorted); the state
// seeded from (m_in, l_in, o_in) takes each live key by the online-softmax
// rescale, a row with no live key so far keeping m = -inf and a correction of
// 0; P rounded to bf16 before P.V; m, l and o out in fp32, always written,
// so a fold with no live key passes the state through bit for bit.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense), at the
// sequence-parallel TransformerLM's fold (B 8, Lq = Lk 256, H 16, D 64): a
// fold whose keys all lie before the rows reads q, k and v in bf16 (12.6 MB)
// and o in and writes o out in fp32 (8.4 MB each way), 29.9 MB with the
// positions, m and l: 8.9 us.  Its 2.15 GFLOP (4 D per live pair) take 2.2 us
// at the tensor-core peak, so bytes bound it, and the fp32 state is most of
// them.
//
// Design: a block is one warpgroup per (64-row q tile, b*h), the last q tile
// first: the ring's positions ascend, so it has the most live keys.  Before
// any K or V byte is read, the block reads the Lk key positions and finds,
// for each 64-key tile, its least live position; a tile is dead when it has
// no live key or, when causal, its least live position lies after the q
// tile's greatest row position (the TPU kernel's dead-block skip at 64-key
// granularity; it holds for unsorted positions).  Only the live tiles stream
// through a 2-stage TMA ring, and their positions are staged into shared
// memory one tile ahead.  The Q tile lands once by TMA.  The carried state
// seeds the registers: m_in and l_in of the thread's two rows, and o_in
// straight into the D / 2-float accumulator fragment.  Per live tile: S =
// Q.K^T by wgmma from shared memory; the live test on each fragment element
// (key_live_at on the row's q_pos in registers and the tile's k_pos); the
// online softmax on the fragment, row max and sum over the quad by shuffles;
// P rounded to bf16 straight into A-operand registers; o += P.V by wgmma with
// V read MN-major.  m, l and o go out straight from registers.

#include <climits>

#include "flash_sm90.cuh"

namespace flash {
namespace sm90 {

constexpr int UPD_STAGES = 2;

// Byte offsets from the 1024-aligned base of dynamic shared memory: the tiles,
// then one int per key tile (its least live position, then the list of live
// tiles, written over it).
template <int D>
struct UpdSmem {
  static constexpr int TILE = TILE_ROWS * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = TILE;                      // stage s at K + s * TILE
  static constexpr int V = TILE * (1 + UPD_STAGES);   // stage s at V + s * TILE
  static constexpr int TILES = TILE * (1 + 2 * UPD_STAGES);
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 2)
    flash_update_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                             const float* __restrict__ m_in, const float* __restrict__ l_in,
                             const float* __restrict__ o_in, float* __restrict__ m_out,
                             float* __restrict__ l_out, float* __restrict__ o_out, int H, int Lq,
                             int Lk, Strides soi, Strides soo, int causal, float scale) {
  using S = UpdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_kv[UPD_STAGES];
  __shared__ int kpos_s[UPD_STAGES][TILE_ROWS];  // a live tile's key positions, by stage
  __shared__ int q_last;                          // the q tile's greatest row position
  __shared__ int n_live;
  uint8_t* base = align_1024(smem_raw);
  const uint32_t base_u = smem_u32(base);
  int* tiles = reinterpret_cast<int*>(base + S::TILES);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the latest positions first
  const int q0 = qt * TILE_ROWS;
  const int n_kt = (Lk + TILE_ROWS - 1) / TILE_ROWS;

  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < UPD_STAGES; ++s) mbar_init(&bar_kv[s], 1);
    fence_barrier_init();
    mbar_expect_tx(&bar_q, S::TILE);
    tma_load_tile(base_u + S::Q, &tq, &bar_q, h, q0, b);
  }
  // the least live position of each key tile (INT_MAX: none), a warp a tile
  for (int t = warp; t < n_kt; t += WG_THREADS / 32) {
    int least = INT_MAX;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = t * TILE_ROWS + half * 32 + lane;
      const int kp = key < Lk ? k_pos[key] : -1;
      if (kp >= 0) least = min(least, kp);
    }
    least = __reduce_min_sync(0xffffffffu, least);
    if (lane == 0) tiles[t] = least;
  }
  if (warp == 0) {
    int latest = INT_MIN;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + half * 32 + lane;
      if (row < Lq) latest = max(latest, q_pos[row]);
    }
    latest = __reduce_max_sync(0xffffffffu, latest);
    if (lane == 0) q_last = latest;
  }
  __syncthreads();
  // keep the live tiles, in order, and start the ring on the first two
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < n_kt; ++t) {
      const int least = tiles[t];
      if (least != INT_MAX && (!causal || least <= q_last)) tiles[n++] = t;
    }
    n_live = n;
    for (int s = 0; s < UPD_STAGES && s < n; ++s) {
      mbar_expect_tx(&bar_kv[s], 2 * S::TILE);
      tma_load_tile(base_u + S::K + s * S::TILE, &tk, &bar_kv[s], h, tiles[s] * TILE_ROWS, b);
      tma_load_tile(base_u + S::V + s * S::TILE, &tv, &bar_kv[s], h, tiles[s] * TILE_ROWS, b);
    }
  }

  // seed the state of this thread's two rows (r = 0: acc_row(0), 1: + 8)
  int qp[2];
  float m[2], l[2];  // l: this thread's share of the row's denominator
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + acc_row(2 * r);
    const bool in = row < Lq;
    const long long state = (long long)bh * Lq + row;
    qp[r] = in ? q_pos[row] : INT_MIN;  // a row past Lq sees no key when causal
    m[r] = in ? m_in[state] : -CUDART_INF_F;
    l[r] = in && tid % 4 == 0 ? l_in[state] : 0.f;  // the quad's sum is l_in
  }
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = q0 + acc_row(i);
    float2 val = make_float2(0.f, 0.f);
    if (row < Lq) {
      val = *reinterpret_cast<const float2*>(o_in + (long long)b * soi.b + (long long)row * soi.l +
                                             (long long)h * soi.h + acc_col(i));
    }
    oacc[i] = val.x;
    oacc[i + 1] = val.y;
  }
  __syncthreads();  // n_live and the list are published
  const int n_it = n_live;
  if (tid < TILE_ROWS && n_it > 0) {
    const int key = tiles[0] * TILE_ROWS + tid;
    kpos_s[0][tid] = key < Lk ? k_pos[key] : -1;
  }
  __syncthreads();
  const uint64_t desc_q = desc_kmajor<D>(base_u + S::Q);
  mbar_wait(&bar_q, 0);

  for (int it = 0; it < n_it; ++it) {
    const int stage = it % UPD_STAGES;
    // the next live tile's positions; their buffer was last read two tiles
    // ago, before the barrier that ended the previous iteration
    if (tid < TILE_ROWS && it + 1 < n_it) {
      const int key = tiles[it + 1] * TILE_ROWS + tid;
      kpos_s[stage ^ 1][tid] = key < Lk ? k_pos[key] : -1;
    }
    const uint64_t desc_k = desc_kmajor<D>(base_u + S::K + stage * S::TILE);
    const uint64_t desc_v = desc_mnmajor<D>(base_u + S::V + stage * S::TILE);
    mbar_wait(&bar_kv[stage], (it / UPD_STAGES) & 1);

    // S = Q . K^T
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_m64n64k16_ss(sacc, k_step_kmajor(desc_q, kk), k_step_kmajor(desc_k, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);

    // online softmax over this key tile; keys past Lk carry position -1
    float cmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float s =
          key_live_at(qp[r], kpos_s[stage][acc_col(i)], causal) ? sacc[i] * scale : -CUDART_INF_F;
      sacc[i] = s;
      cmax[r] = fmaxf(cmax[r], s);
    }
    float shift[2];  // safe_m * log2(e): p = 2^(s * log2(e) - shift)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float safe_m;
      const float corr = online_rescale(m[r], quad_max(cmax[r]), safe_m);
      l[r] *= corr;
      shift[r] = safe_m * LOG2E;
#pragma unroll
      for (int i = 2 * r; i < D / 2; i += 4) {
        oacc[i] *= corr;
        oacc[i + 1] *= corr;
      }
    }
    uint32_t pf[4][4];  // P in bf16, as the A operand of the 4 steps of P.V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;
        const float p0 = exp2f(fmaf(sacc[i], LOG2E, -shift[j & 1]));
        const float p1 = exp2f(fmaf(sacc[i + 1], LOG2E, -shift[j & 1]));
        l[j & 1] += p0 + p1;  // the denominator sums P before rounding
        pf[kk][j] = pack_bf16(p0, p1);
      }
    }

    // o += P . V
    fence_regs(oacc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pf[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(oacc, pf[kk], k_step_mnmajor<D>(desc_v, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(oacc);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && it + UPD_STAGES < n_it) {
      const int row = tiles[it + UPD_STAGES] * TILE_ROWS;
      mbar_expect_tx(&bar_kv[stage], 2 * S::TILE);
      tma_load_tile(base_u + S::K + stage * S::TILE, &tk, &bar_kv[stage], h, row, b);
      tma_load_tile(base_u + S::V + stage * S::TILE, &tv, &bar_kv[stage], h, row, b);
    }
  }

  // the state is written whatever happened, as the TPU kernel's _finish does
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    const int row = q0 + acc_row(2 * r);
    if (tid % 4 == 0 && row < Lq) {
      m_out[(long long)bh * Lq + row] = m[r];
      l_out[(long long)bh * Lq + row] = l[r];
    }
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = q0 + acc_row(i);
    if (row < Lq) {
      *reinterpret_cast<float2*>(o_out + (long long)b * soo.b + (long long)row * soo.l +
                                 (long long)h * soo.h + acc_col(i)) = make_float2(oacc[i],
                                                                                  oacc[i + 1]);
    }
  }
}

template <int D>
cudaError_t launch_update(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                          const void* q_pos, const void* k_pos, const void* m_in,
                          const void* l_in, const void* o_in, void* m_out, void* l_out,
                          void* o_out, int B, int H, int Lq, int Lk, Strides soi, Strides soo,
                          int causal, float scale, cudaStream_t stream) {
  const int n_kt = (Lk + TILE_ROWS - 1) / TILE_ROWS;
  // + one int per key tile, + slack to align the base
  const int smem = UpdSmem<D>::TILES + 4 * n_kt + 1024;
  const auto kernel = flash_update_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Lq + TILE_ROWS - 1) / TILE_ROWS);
  kernel<<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
      static_cast<const float*>(m_in), static_cast<const float*>(l_in),
      static_cast<const float*>(o_in), static_cast<float*>(m_out), static_cast<float*>(l_out),
      static_cast<float*>(o_out), H, Lq, Lk, soi, soo, causal, scale);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace flash

// bf16 q, k, v only; D: 32 or 64.  q_pos [Lq] and k_pos [Lk] are int32; m_in,
// l_in, m_out, l_out contiguous fp32 [B, H, Lq]; o_in, o_out fp32 [B, Lq, H,
// D], each base 8-byte aligned with even strides.  strides: 15 int64, the
// (b, l, h) element strides of q, k, v (each a multiple of 8 and each base
// 16-byte aligned: TMA), o_in and o_out.  Returns the launch's cudaError_t, or
// a negative flash::sm90::ERR_ code when no tensor map could be made.
extern "C" int flash_update_sm90(const void* q, const void* k, const void* v, const void* q_pos,
                                 const void* k_pos, const void* m_in, const void* l_in,
                                 const void* o_in, void* m_out, void* l_out, void* o_out, int B,
                                 int H, int Lq, int Lk, int D, int causal, float scale,
                                 const void* strides, void* stream) {
  using namespace flash::sm90;
  const long long* st = static_cast<const long long*>(strides);
  if (D != 32 && D != 64) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int rc = make_tile_map(&tq, q, B, Lq, H, D, flash::strides_at(st, 0));
  if (rc == 0) rc = make_tile_map(&tk, k, B, Lk, H, D, flash::strides_at(st, 1));
  if (rc == 0) rc = make_tile_map(&tv, v, B, Lk, H, D, flash::strides_at(st, 2));
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const flash::Strides soi = flash::strides_at(st, 3);
  const flash::Strides soo = flash::strides_at(st, 4);
  const cudaError_t err =
      D == 64 ? launch_update<64>(tq, tk, tv, q_pos, k_pos, m_in, l_in, o_in, m_out, l_out,
                                  o_out, B, H, Lq, Lk, soi, soo, causal, scale, s)
              : launch_update<32>(tq, tk, tv, q_pos, k_pos, m_in, l_in, o_in, m_out, l_out,
                                  o_out, B, H, Lq, Lk, soi, soo, causal, scale, s);
  return static_cast<int>(err);
}
