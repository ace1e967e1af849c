// Flash-attention forward for Hopper (sm_90a), bf16: O and the per-row LSE on
// the tensor cores.
//
// Replaces: fedml_tpu/ops/flash_attention.py:_flash_kernel (the Pallas TPU
// kernel launched by _flash_forward) for bf16 inputs; fp32 inputs take the
// scalar kernel of flash_fwd.cu.  Same function: scores = q.k^T / sqrt(D) as
// fp32 sums of exact bf16 products, keys at or past L masked and, when causal,
// keys after the row; online softmax in fp32; P rounded to bf16 before P.V;
// O in bf16 and LSE in fp32 (-inf for a row with no live key).
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// TransformerLM bench shape (B 8, L 1024, H 16, D 64, causal) it reads q, k, v
// and writes O and LSE, 67.6 MB, 20.2 us, so bytes bound it; its 17.2 GFLOP
// of live pairs come close, 17.4 us at the tensor-core peak.  At D 64 each
// 64 x 64 tile of scores costs as many exponentials (16 a clock on an SM) as
// tensor-core clocks, so the softmax, not the products, is what a block waits
// on.
//
// Design: a block is one warpgroup (128 threads) that owns a 64-row q tile of
// one (b, h); blocks run the heaviest causal q tile first, so the last wave is
// not one long tile.  Q lands once in shared memory; K and V tiles of 64 keys
// stream through a 2-stage ring that one thread feeds with TMA (tensor maps
// over [B, L, H, D] with the real strides, so fused-qkv views need no copy;
// rows past L arrive zero-filled and only the score mask sees the edge).  Per
// key tile: S = Q.K^T by wgmma m64n64k16 from shared memory into fp32
// registers; the online softmax on that fragment (row max and sum over the
// quad by shuffles, the sum kept per thread until the end); P rounded to bf16
// straight into A-operand registers; O += P.V by wgmma with A from registers
// and V read MN-major from shared memory.  A causal tile visits only key
// tiles up to its diagonal and masks only that one (and the ragged last one).
// About 5 blocks share an SM, so one block's softmax overlaps another's
// products.  O is staged through shared memory for 16-byte coalesced stores.

#include "flash_sm90.cuh"

namespace flash {
namespace sm90 {

constexpr int FWD_STAGES = 2;

// Byte offsets of the tiles from the 1024-aligned base of dynamic shared memory.
template <int D>
struct FwdSmem {
  static constexpr int TILE = TILE_ROWS * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = TILE;                     // stage s at K + s * TILE
  static constexpr int V = TILE * (1 + FWD_STAGES);  // stage s at V + s * TILE
  static constexpr int BYTES = TILE * (1 + 2 * FWD_STAGES);
  static_assert(TILE_ROWS * (D + OUT_PAD) * 2 <= BYTES, "O's staging fits");
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 3)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int H, int L, Strides so, int causal,
                          float scale) {
  using S = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_kv[FWD_STAGES];
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
    for (int s = 0; s < FWD_STAGES; ++s) mbar_init(&bar_kv[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_q, S::TILE);
    tma_load_tile(base_u + S::Q, &tq, &bar_q, h, q0, b);
    for (int s = 0; s < FWD_STAGES && s < n_kt; ++s) {
      mbar_expect_tx(&bar_kv[s], 2 * S::TILE);
      tma_load_tile(base_u + S::K + s * S::TILE, &tk, &bar_kv[s], h, s * TILE_ROWS, b);
      tma_load_tile(base_u + S::V + s * S::TILE, &tv, &bar_kv[s], h, s * TILE_ROWS, b);
    }
  }

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's denominator
  const uint64_t desc_q = desc_kmajor<D>(base_u + S::Q);
  mbar_wait(&bar_q, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt % FWD_STAGES;
    const uint64_t desc_k = desc_kmajor<D>(base_u + S::K + stage * S::TILE);
    const uint64_t desc_v = desc_mnmajor<D>(base_u + S::V + stage * S::TILE);
    mbar_wait(&bar_kv[stage], (kt / FWD_STAGES) & 1);

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

    // online softmax over this key tile
    const int k0 = kt * TILE_ROWS;
    const bool masked = (causal && kt == qt) || k0 + TILE_ROWS > L;
    float cmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float s = sacc[i] * scale;
      if (masked && !key_live(q0 + acc_row(i), k0 + acc_col(i), L, causal)) s = -CUDART_INF_F;
      sacc[i] = s;
      cmax[(i >> 1) & 1] = fmaxf(cmax[(i >> 1) & 1], s);
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

    // O += P . V
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
    if (tid == 0 && kt + FWD_STAGES < n_kt) {
      const int row = (kt + FWD_STAGES) * TILE_ROWS;
      mbar_expect_tx(&bar_kv[stage], 2 * S::TILE);
      tma_load_tile(base_u + S::K + stage * S::TILE, &tk, &bar_kv[stage], h, row, b);
      tma_load_tile(base_u + S::V + stage * S::TILE, &tv, &bar_kv[stage], h, row, b);
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(l[r], 1e-20f);
    const int row = q0 + acc_row(2 * r);
    if (tid % 4 == 0 && row < L) lse[(long long)bh * L + row] = row_lse(m[r], l[r]);
  }
  // the loop ended on a barrier after the last product: the tiles are free
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(base);
  stage_acc<D>(st, oacc, inv);
  __syncthreads();
  store_tile<D>(o, so, st, b, h, q0, L);
}

template <int D>
cudaError_t launch_fwd(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                       void* o, void* lse, int B, int H, int L, Strides so, int causal,
                       float scale, cudaStream_t stream) {
  constexpr int smem = FwdSmem<D>::BYTES + 1024;  // + slack to align the base
  const auto kernel = flash_fwd_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + TILE_ROWS - 1) / TILE_ROWS);
  kernel<<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, L, so, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace flash

// bf16 only; D: 32 or 64.  strides: 12 int64, the (b, l, h) element strides of
// q, k, v and o; each a multiple of 8 and each base 16-byte aligned (TMA).
// Returns the launch's cudaError_t, or a negative flash::sm90::ERR_ code when
// no tensor map could be made.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int H, int L, int D, int causal, float scale,
                              const void* strides, void* stream) {
  using namespace flash::sm90;
  const long long* st = static_cast<const long long*>(strides);
  if (D != 32 && D != 64) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int rc = make_tile_map(&tq, q, B, L, H, D, flash::strides_at(st, 0));
  if (rc == 0) rc = make_tile_map(&tk, k, B, L, H, D, flash::strides_at(st, 1));
  if (rc == 0) rc = make_tile_map(&tv, v, B, L, H, D, flash::strides_at(st, 2));
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const flash::Strides so = flash::strides_at(st, 3);
  const cudaError_t err =
      D == 64 ? launch_fwd<64>(tq, tk, tv, o, lse, B, H, L, so, causal, scale, s)
              : launch_fwd<32>(tq, tk, tv, o, lse, B, H, L, so, causal, scale, s);
  return static_cast<int>(err);
}
