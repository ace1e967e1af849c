// Flash-attention dQ for Hopper (sm_90a), bf16, on the tensor cores.
//
// Replaces: fedml_tpu/ops/flash_attention.py:_flash_bwd_dq_kernel (the Pallas
// TPU kernel launched by _flash_backward) for bf16 inputs; fp32 inputs take
// flash_bwd.cu's split-TF32 kernel.  Same function: P rebuilt from (q, k,
// lse) and dS = P * (dO.V^T - delta) * scale through the block_grads of
// flash_common.cuh, which the dK/dV kernel shares, on every accumulator
// element; dS rounded to bf16 before dS.K, as the Pallas kernel's
// ds.astype(k.dtype); fp32 sums of exact bf16 products; dQ in bf16.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// TransformerLM bench shape (B 8, L 1024, H 16, D 64, causal) it reads q, k,
// v, dO, lse and delta and writes dQ, 84 MB, 25 us; its three products per
// live pair (S = Q.K^T, dP = dO.V^T, dQ += dS.K) are 25.8 GFLOP, 26 us at the
// tensor-core peak: the two bounds meet.  As in the forward, one exponential
// per score sits beside 6 D tensor-core operations, so the elementwise step
// is what a block waits on.
//
// Design: a block is one warpgroup (128 threads) that owns a 64-row q tile of
// one (b, h); the last q tile, which sees every key tile when causal, is
// issued first.  Its Q and dO tiles land once by TMA and stay in shared
// memory; K and V tiles of 64 keys stream through a 2-stage TMA ring from key
// tile 0 to the q tile's diagonal tile (to L when not causal), which replaces
// the TPU kernel's sequential grid axis.  Each thread keeps the lse and delta
// of its two fragment rows in registers (rows past L get lse = -inf, so
// block_grads gives them dS = 0).  Per key tile: S = Q.K^T and dP = dO.V^T by
// wgmma from shared memory (both operands K-major); dS element by element,
// rounded to bf16 straight into A-operand registers; dQ += dS.K by wgmma with
// K read MN-major from the same ring stage that fed S, the P.V form of the
// forward.  dQ stays in fp32 registers (D / 2 a thread) across the loop and
// goes out through a staged tile in 16-byte stores; no two blocks write the
// same row, so no atomics.

#include "flash_sm90.cuh"

namespace flash {
namespace sm90 {

constexpr int DQ_STAGES = 2;

// Byte offsets of the tiles from the 1024-aligned base of dynamic shared memory.
template <int D>
struct DqSmem {
  static constexpr int TILE = TILE_ROWS * D * 2;
  static constexpr int Q = 0;
  static constexpr int DO = TILE;
  static constexpr int K = 2 * TILE;                   // stage s at K + s * TILE
  static constexpr int V = TILE * (2 + DQ_STAGES);     // stage s at V + s * TILE
  static constexpr int BYTES = TILE * (2 + 2 * DQ_STAGES);
  static_assert(TILE_ROWS * (D + OUT_PAD) * 2 <= BYTES, "dQ's staging fits");
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 2)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int H, int L, Strides sdq, int causal,
                         float scale) {
  using S = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_kv[DQ_STAGES];
  uint8_t* base = align_1024(smem_raw);
  const uint32_t base_u = smem_u32(base);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the heaviest causal q tile first
  const int q0 = qt * TILE_ROWS;
  const int n_k = (L + TILE_ROWS - 1) / TILE_ROWS;
  const int n_kt = causal ? min(n_k, qt + 1) : n_k;  // no row sees a key past its tile

  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < DQ_STAGES; ++s) mbar_init(&bar_kv[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_q, 2 * S::TILE);
    tma_load_tile(base_u + S::Q, &tq, &bar_q, h, q0, b);
    tma_load_tile(base_u + S::DO, &tdo, &bar_q, h, q0, b);
    for (int s = 0; s < DQ_STAGES && s < n_kt; ++s) {
      mbar_expect_tx(&bar_kv[s], 2 * S::TILE);
      tma_load_tile(base_u + S::K + s * S::TILE, &tk, &bar_kv[s], h, s * TILE_ROWS, b);
      tma_load_tile(base_u + S::V + s * S::TILE, &tv, &bar_kv[s], h, s * TILE_ROWS, b);
    }
  }

  // the lse and delta of this thread's two rows (r = 0: acc_row(0), 1: + 8)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + acc_row(2 * r);
    lse_r[r] = pos < L ? lse[(long long)bh * L + pos] : -CUDART_INF_F;
    delta_r[r] = pos < L ? delta[(long long)bh * L + pos] : 0.f;
  }
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  const uint64_t desc_q = desc_kmajor<D>(base_u + S::Q);
  const uint64_t desc_do = desc_kmajor<D>(base_u + S::DO);
  mbar_wait(&bar_q, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt % DQ_STAGES;
    const uint32_t k_addr = base_u + S::K + stage * S::TILE;  // K-major for S, MN for dS.K
    const uint32_t v_addr = base_u + S::V + stage * S::TILE;
    mbar_wait(&bar_kv[stage], (kt / DQ_STAGES) & 1);

    // S = Q . K^T and dP = dO . V^T, q rows along M
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
      wgmma_m64n64k16_ss(sacc, k_step_kmajor(desc_q, kk),
                         k_step_kmajor(desc_kmajor<D>(k_addr), kk));
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_m64n64k16_ss(dpacc, k_step_kmajor(desc_do, kk),
                         k_step_kmajor(desc_kmajor<D>(v_addr), kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(dpacc);

    // dS, element by element, into bf16 A operands
    const int k0 = kt * TILE_ROWS;
    const bool masked = (causal && kt == qt) || k0 + TILE_ROWS > L;
    uint32_t df[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p, ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * kk + 2 * j + e;
          const bool live = !masked || key_live(q0 + acc_row(i), k0 + acc_col(i), L, causal);
          block_grads(sacc[i] * scale, dpacc[i], lse_r[j & 1], delta_r[j & 1], live, scale, p,
                      ds[e]);
        }
        df[kk][j] = pack_bf16(ds[0], ds[1]);  // dS enters dS.K in bf16
      }
    }

    // dQ += dS . K, keys along K
    fence_regs(dq_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(df[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(dq_acc, df[kk], k_step_mnmajor<D>(desc_mnmajor<D>(k_addr), kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq_acc);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && kt + DQ_STAGES < n_kt) {
      const int row = (kt + DQ_STAGES) * TILE_ROWS;
      mbar_expect_tx(&bar_kv[stage], 2 * S::TILE);
      tma_load_tile(base_u + S::K + stage * S::TILE, &tk, &bar_kv[stage], h, row, b);
      tma_load_tile(base_u + S::V + stage * S::TILE, &tv, &bar_kv[stage], h, row, b);
    }
  }

  // the loop ended on a barrier after the last product: the tiles are free
  // (with no key tile at all, the Q and dO loads completed before the loop)
  const float one[2] = {1.f, 1.f};
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(base);
  stage_acc<D>(st, dq_acc, one);
  __syncthreads();
  store_tile<D>(dq, sdq, st, b, h, q0, L);
}

template <int D>
cudaError_t launch_dq(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                      const CUtensorMap& tdo, const void* lse, const void* delta, void* dq,
                      int B, int H, int L, Strides sdq, int causal, float scale,
                      cudaStream_t stream) {
  constexpr int smem = DqSmem<D>::BYTES + 1024;  // + slack to align the base
  const auto kernel = flash_dq_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + TILE_ROWS - 1) / TILE_ROWS);
  kernel<<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), H, L, sdq, causal, scale);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace flash

// bf16 only; D: 32 or 64.  strides: 15 int64, the (b, l, h) element strides of
// q, k, v, dO and dq; each a multiple of 8 and each base 16-byte aligned
// (TMA).  lse and delta: contiguous fp32 [B, H, L].  Returns the launch's
// cudaError_t, or a negative flash::sm90::ERR_ code when no tensor map could
// be made.
extern "C" int flash_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq, int B, int H, int L,
                             int D, int causal, float scale, const void* strides, void* stream) {
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
  const flash::Strides sdq = flash::strides_at(st, 4);
  const cudaError_t err =
      D == 64 ? launch_dq<64>(tq, tk, tv, tdo, lse, delta, dq, B, H, L, sdq, causal, scale, s)
              : launch_dq<32>(tq, tk, tv, tdo, lse, delta, dq, B, H, L, sdq, causal, scale, s);
  return static_cast<int>(err);
}
