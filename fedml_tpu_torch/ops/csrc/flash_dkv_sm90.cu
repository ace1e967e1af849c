// Flash-attention dK/dV for Hopper (sm_90a), bf16, on the tensor cores.
//
// Replaces: fedml_tpu/ops/flash_attention.py:_flash_bwd_dkv_kernel (the Pallas
// TPU kernel launched by _flash_backward) for bf16 inputs; fp32 inputs take
// flash_bwd.cu's split-TF32 kernel.  Same function: P rebuilt from (q, k,
// lse) and dS = P * (dO.V^T - delta) * scale through the block_grads of
// flash_common.cuh, which dQ's kernel shares, on every accumulator element;
// P rounded to bf16 before P^T.dO and dS before dS^T.Q; fp32 sums of exact
// bf16 products; dK and dV in bf16.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// TransformerLM bench shape (B 8, L 1024, H 16, D 64, causal) it reads q, k,
// v, dO, lse and delta and writes dK and dV, 101 MB, 30 us; its 34.4 GFLOP of
// live pairs (four products per pair) take 35 us at the tensor-core peak:
// the two bounds meet.  As in the forward, one exponential per score sits
// beside every 4 D tensor-core operations, so the elementwise step, not the
// products, is what a block waits on.
//
// Design: a block is one warpgroup that owns a 64-key tile of one (b, h); its
// K and V tiles stay resident in shared memory (TMA, once).  A loop over the
// 64-row q tiles, from the first one a causal key can see to L, replaces the
// TPU kernel's sequential grid axis; Q and dO tiles stream through a 2-stage
// TMA ring, and each tile's lse and delta rows are staged into shared memory
// one tile ahead.  Per q tile, with the keys as the wgmma M dimension:
// S^T = K.Q^T and dP^T = V.dO^T by wgmma from shared memory; P^T and dS^T from
// block_grads on each fragment element, rounded to bf16 into A-operand
// registers; dV += P^T.dO and dK += dS^T.Q by wgmma with A from registers and
// dO, Q read MN-major from the same tiles that fed the first two products.
// dK and dV stay in fp32 registers across the loop (D / 2 a thread each), and
// no two blocks write the same rows: no atomics.  Key tile 0, which sees every
// q tile when causal, is issued first.

#include "flash_sm90.cuh"

namespace flash {
namespace sm90 {

constexpr int DKV_STAGES = 2;

template <int D>
struct DkvSmem {
  static constexpr int TILE = TILE_ROWS * D * 2;
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int Q = 2 * TILE;                    // stage s at Q + s * TILE
  static constexpr int DO = TILE * (2 + DKV_STAGES);    // stage s at DO + s * TILE
  static constexpr int BYTES = TILE * (2 + 2 * DKV_STAGES);
  static_assert(2 * TILE_ROWS * (D + OUT_PAD) * 2 <= BYTES, "dK's and dV's staging fits");
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 2)
    flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                          int L, Strides sdk, Strides sdv, int causal, float scale) {
  using S = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv;
  __shared__ __align__(8) uint64_t bar_q[DKV_STAGES];
  __shared__ float lse_s[2][TILE_ROWS];  // double-buffered by q tile
  __shared__ float delta_s[2][TILE_ROWS];
  uint8_t* base = align_1024(smem_raw);
  const uint32_t base_u = smem_u32(base);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kt = blockIdx.y;  // key tile 0 has the most causal work: it goes first
  const int k0 = kt * TILE_ROWS;
  const int n_q = (L + TILE_ROWS - 1) / TILE_ROWS;
  const int qt0 = causal ? kt : 0;  // a query row before this tile sees none of its keys
  const int n_it = n_q - qt0;
  const float* lse_bh = lse + (long long)bh * L;
  const float* delta_bh = delta + (long long)bh * L;

  if (tid == 0) {
    mbar_init(&bar_kv, 1);
    for (int s = 0; s < DKV_STAGES; ++s) mbar_init(&bar_q[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_kv, 2 * S::TILE);
    tma_load_tile(base_u + S::K, &tk, &bar_kv, h, k0, b);
    tma_load_tile(base_u + S::V, &tv, &bar_kv, h, k0, b);
    for (int s = 0; s < DKV_STAGES && s < n_it; ++s) {
      const int row = (qt0 + s) * TILE_ROWS;
      mbar_expect_tx(&bar_q[s], 2 * S::TILE);
      tma_load_tile(base_u + S::Q + s * S::TILE, &tq, &bar_q[s], h, row, b);
      tma_load_tile(base_u + S::DO + s * S::TILE, &tdo, &bar_q[s], h, row, b);
    }
  }
  // rows past L get lse = -inf, so block_grads gives them P = dS = 0
  if (tid < TILE_ROWS) {
    const int pos = qt0 * TILE_ROWS + tid;
    lse_s[0][tid] = pos < L ? lse_bh[pos] : -CUDART_INF_F;
    delta_s[0][tid] = pos < L ? delta_bh[pos] : 0.f;
  }
  __syncthreads();

  float dk_acc[D / 2];
  float dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  const uint64_t desc_k = desc_kmajor<D>(base_u + S::K);
  const uint64_t desc_v = desc_kmajor<D>(base_u + S::V);
  mbar_wait(&bar_kv, 0);

  for (int it = 0; it < n_it; ++it) {
    const int qt = qt0 + it;
    const int q0 = qt * TILE_ROWS;
    const int stage = it % DKV_STAGES;
    const int buf = it & 1;
    // the next tile's row statistics; their buffer was last read two tiles
    // ago, before the barrier that ended the previous iteration
    if (tid < TILE_ROWS && it + 1 < n_it) {
      const int pos = q0 + TILE_ROWS + tid;
      lse_s[buf ^ 1][tid] = pos < L ? lse_bh[pos] : -CUDART_INF_F;
      delta_s[buf ^ 1][tid] = pos < L ? delta_bh[pos] : 0.f;
    }
    const uint32_t q_addr = base_u + S::Q + stage * S::TILE;  // K-major for S^T, MN for dK
    const uint32_t do_addr = base_u + S::DO + stage * S::TILE;
    mbar_wait(&bar_q[stage], (it / DKV_STAGES) & 1);

    // S^T = K . Q^T and dP^T = V . dO^T, keys along M
    float sacc[32];
    float dpacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sacc[i] = 0.f;
      dpacc[i] = 0.f;
    }
    fence_regs(sacc);
    fence_regs(dpacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_m64n64k16_ss(sacc, k_step_kmajor(desc_k, kk),
                         k_step_kmajor(desc_kmajor<D>(q_addr), kk));
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_m64n64k16_ss(dpacc, k_step_kmajor(desc_v, kk),
                         k_step_kmajor(desc_kmajor<D>(do_addr), kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(dpacc);

    // P^T and dS^T, element by element, into bf16 A operands
    const bool masked = (causal && qt == kt) || k0 + TILE_ROWS > L;
    uint32_t pf[4][4];
    uint32_t df[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * kk + 2 * j + e;
          const int qc = acc_col(i);
          const bool live = !masked || key_live(q0 + qc, k0 + acc_row(i), L, causal);
          block_grads(sacc[i] * scale, dpacc[i], lse_s[buf][qc], delta_s[buf][qc], live, scale,
                      p[e], ds[e]);
        }
        pf[kk][j] = pack_bf16(p[0], p[1]);
        df[kk][j] = pack_bf16(ds[0], ds[1]);
      }
    }

    // dV += P^T . dO and dK += dS^T . Q, q rows along K
    fence_regs(dv_acc);
    fence_regs(dk_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(pf[kk]);
      fence_regs(df[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(dv_acc, pf[kk], k_step_mnmajor<D>(desc_mnmajor<D>(do_addr), kk));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(dk_acc, df[kk], k_step_mnmajor<D>(desc_mnmajor<D>(q_addr), kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && it + DKV_STAGES < n_it) {
      const int row = (qt + DKV_STAGES) * TILE_ROWS;
      mbar_expect_tx(&bar_q[stage], 2 * S::TILE);
      tma_load_tile(base_u + S::Q + stage * S::TILE, &tq, &bar_q[stage], h, row, b);
      tma_load_tile(base_u + S::DO + stage * S::TILE, &tdo, &bar_q[stage], h, row, b);
    }
  }

  // the loop ended on a barrier after the last product: the tiles are free
  const float one[2] = {1.f, 1.f};
  __nv_bfloat16* st_k = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* st_v = st_k + TILE_ROWS * (D + OUT_PAD);
  stage_acc<D>(st_k, dk_acc, one);
  stage_acc<D>(st_v, dv_acc, one);
  __syncthreads();
  store_tile<D>(dk, sdk, st_k, b, h, k0, L);
  store_tile<D>(dv, sdv, st_v, b, h, k0, L);
}

template <int D>
cudaError_t launch_dkv(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                       const CUtensorMap& tdo, const void* lse, const void* delta, void* dk,
                       void* dv, int B, int H, int L, Strides sdk, Strides sdv, int causal,
                       float scale, cudaStream_t stream) {
  constexpr int smem = DkvSmem<D>::BYTES + 1024;  // + slack to align the base
  const auto kernel = flash_dkv_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + TILE_ROWS - 1) / TILE_ROWS);
  kernel<<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, L, sdk, sdv, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace flash

// bf16 only; D: 32 or 64.  strides: 18 int64, the (b, l, h) element strides of
// q, k, v, dO, dk and dv; each a multiple of 8 and each base 16-byte aligned
// (TMA).  lse and delta: contiguous fp32 [B, H, L].  Returns the launch's
// cudaError_t, or a negative flash::sm90::ERR_ code when no tensor map could
// be made.
extern "C" int flash_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dk, void* dv, int B,
                              int H, int L, int D, int causal, float scale, const void* strides,
                              void* stream) {
  using namespace flash::sm90;
  const long long* st = static_cast<const long long*>(strides);
  if (D != 32 && D != 64) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_tile_map(&tq, q, B, L, H, D, flash::strides_at(st, 0));
  if (rc == 0) rc = make_tile_map(&tk, k, B, L, H, D, flash::strides_at(st, 1));
  if (rc == 0) rc = make_tile_map(&tv, v, B, L, H, D, flash::strides_at(st, 2));
  if (rc == 0) rc = make_tile_map(&tdo, dout, B, L, H, D, flash::strides_at(st, 3));
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const flash::Strides sdk = flash::strides_at(st, 4);
  const flash::Strides sdv = flash::strides_at(st, 5);
  const cudaError_t err =
      D == 64 ? launch_dkv<64>(tq, tk, tv, tdo, lse, delta, dk, dv, B, H, L, sdk, sdv, causal,
                               scale, s)
              : launch_dkv<32>(tq, tk, tv, tdo, lse, delta, dk, dv, B, H, L, sdk, sdv, causal,
                               scale, s);
  return static_cast<int>(err);
}
