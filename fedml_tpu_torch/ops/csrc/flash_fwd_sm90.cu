// Flash-attention forward for Hopper (sm_90a), bf16: O and the per-row LSE on
// the tensor cores, warp-specialised.
//
// Replaces: fedml_tpu/ops/flash_attention.py:_flash_kernel (the Pallas TPU
// kernel launched by _flash_forward) for bf16 inputs; fp32 inputs take
// flash_fwd.cu.  Same function: scores = q.k^T / sqrt(D) as fp32 sums of
// exact bf16 products, keys at or past L masked and, when causal, keys after
// the row; online softmax in fp32; P rounded to bf16 before P.V (the
// denominator sums P before rounding); O in bf16 and LSE in fp32 (-inf for a
// row with no live key).
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// TransformerLM bench shape (B 8, L 1024, H 16, D 64, causal) it reads q, k, v
// and writes O and LSE, 67.6 MB, 20.2 us, so bytes bound it; its 17.2 GFLOP
// of live pairs come close, 17.4 us at the tensor-core peak.  At D 64 each
// 64 x 64 tile of scores costs as many exponentials (16 a clock on an SM) as
// tensor-core clocks, so a warpgroup that waits for its products before its
// softmax and for its softmax before its next products leaves the tensor
// cores idle half the time.
//
// Design: a block is three warpgroups, persistent over 128-row q tiles of
// (b, h), heaviest causal tiles first, one block per SM.  Warpgroup 0, the
// producer, gives up registers (setmaxnreg) and one of its threads issues
// every TMA load: each q tile's Q (two 64-row tiles, double-buffered so the
// next tile's Q arrives while this one is in use) and its K and V tiles of
// 64 keys through a 4-stage ring, each stage with a "full" mbarrier (TMA's
// bytes landed) and an "empty" one (every consumer warp is done with it); no
// __syncthreads() after the set-up.  Warpgroups 1 and 2, the consumers, own
// 64 rows each of the q tile and share every K/V tile, so a K/V tile is read
// once for 128 rows.  In each consumer, S for key tile j + 1 is issued
// (wgmma, commit) before the exponentials of tile j and waited for with
// wgmma.wait_group 1 while P.V of tile j runs; the next tile's row max is
// taken under that P.V, and O is rescaled only when no product is in flight
// (with a product in flight across the loop's back edge, or O written under
// one, ptxas serialises every wgmma of the kernel).  The online softmax runs
// on the accumulator fragment (row max and sum over the quad by shuffles,
// the sum kept per thread until the end), with the scale folded into the
// exponent; P goes to bf16 A-operand registers; V is read MN-major from the
// stage.  Only a consumer's last key tile can hold its causal diagonal or the
// ragged edge, so the mask is applied there alone, outside the steady loop.
// Tensor maps carry the real strides, so fused-qkv views need no copy, and
// rows past L arrive zero-filled.  O is staged through shared memory per
// consumer for 16-byte coalesced stores.
//
// Measured (PERF.md): a step of two 64 x 64 tiles takes about 1 us of the SM
// whatever the consumers' order of work; ping-pong between the consumers
// (named barriers), a third consumer, more stages and 128-key tiles (which
// spill) did not make it faster, and the kernel is slower than the design it
// replaced, five single-warpgroup blocks an SM.

#include "flash_sm90.cuh"

namespace flash {
namespace sm90 {

constexpr int FWD_STAGES = 4;
constexpr int FWD_CONSUMERS = 2;                                // 64-row consumer warpgroups
constexpr int FWD_THREADS = WG_THREADS * (1 + FWD_CONSUMERS);   // 384
constexpr int FWD_BQ = TILE_ROWS * FWD_CONSUMERS;               // 128 rows a q tile
constexpr int FWD_CONSUMER_WARPS = 4 * FWD_CONSUMERS;           // arrivals that free a buffer
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 = 64,512 of the
// SM's 65,536 (ptxas still holds every thread to the launch count, 168)
constexpr int FWD_PRODUCER_REGS = 40;
constexpr int FWD_CONSUMER_REGS = 232;
constexpr int FWD_SMEM_ONE_BLOCK = 120 * 1024;  // of the 228 KB an SM shares among its blocks

// Byte offsets of the tiles from the 1024-aligned base of dynamic shared memory.
template <int D>
struct FwdSmem {
  static constexpr int TILE = TILE_ROWS * D * 2;
  static constexpr int Q = 0;  // buffer x, consumer c at Q + (x * FWD_CONSUMERS + c) * TILE
  static constexpr int K = 2 * TILE * FWD_CONSUMERS;        // stage s at K + s * TILE
  static constexpr int V = K + TILE * FWD_STAGES;           // stage s at V + s * TILE
  static constexpr int OUT = V + TILE * FWD_STAGES;         // consumer c's at OUT + c * OUT_TILE
  static constexpr int OUT_TILE = TILE_ROWS * (D + OUT_PAD) * 2;
  static constexpr int BYTES = OUT + OUT_TILE * FWD_CONSUMERS;
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Synchronise the 128 threads of one warpgroup on named barrier id (1 or 2).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WG_THREADS) : "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory
// (K-major); the sum starts from zero when !accumulate.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Copy a staged 64 x D tile to rows [row0, row0 + 64) of one (b, h) slice, 16
// bytes a thread at a time, by the 128 threads of one warpgroup (lane index
// i), skipping rows at or past L.
template <int D>
__device__ __forceinline__ void store_tile_wg(__nv_bfloat16* __restrict__ dst, Strides s,
                                              const __nv_bfloat16* st, int b, int h, int row0,
                                              int L, int i) {
  constexpr int CHUNKS = D / 8;
  for (int c = i; c < TILE_ROWS * CHUNKS; c += WG_THREADS) {
    const int r = c / CHUNKS;
    const int cc = c - r * CHUNKS;
    if (row0 + r < L) {
      *reinterpret_cast<uint4*>(dst + (long long)b * s.b + (long long)(row0 + r) * s.l +
                                (long long)h * s.h + cc * 8) =
          *reinterpret_cast<const uint4*>(st + r * (D + OUT_PAD) + cc * 8);
    }
  }
}

// The n-th q tile of the block's walk: the heaviest causal tiles first, every
// (b, h) of one tile index before the next.
struct QTile {
  int b, h, bh, qt;
};
__device__ __forceinline__ QTile q_tile(int i, int H, int BH, int n_qt) {
  QTile t;
  t.qt = n_qt - 1 - i / BH;
  t.bh = i - (i / BH) * BH;
  t.b = t.bh / H;
  t.h = t.bh - t.b * H;
  return t;
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int H, int BH, int L, Strides so, int causal,
                          float scale) {
  using S = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[FWD_STAGES];
  __shared__ __align__(8) uint64_t empty[FWD_STAGES];
  __shared__ __align__(8) uint64_t q_full[2];  // Q is double-buffered: tile n in buffer n % 2
  __shared__ __align__(8) uint64_t q_empty[2];
  uint8_t* base = align_1024(smem_raw);
  const uint32_t base_u = smem_u32(base);

  const int wg = threadIdx.x / WG_THREADS;
  const int n_k = (L + TILE_ROWS - 1) / TILE_ROWS;  // K/V tiles of TILE_ROWS keys
  const int n_qt = (L + FWD_BQ - 1) / FWD_BQ;
  const int n_tiles = BH * n_qt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], FWD_CONSUMER_WARPS);
    }
    for (int x = 0; x < 2; ++x) {
      mbar_init(&q_full[x], 1);
      mbar_init(&q_empty[x], FWD_CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FWD_PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int it = 0;  // K/V tiles loaded so far, over the whole walk
      int n = 0;   // q tiles so far
      for (int i = blockIdx.x; i < n_tiles; i += gridDim.x, ++n) {
        const QTile t = q_tile(i, H, BH, n_qt);
        const int q0 = t.qt * FWD_BQ;
        const int n_kt = causal ? min(n_k, FWD_CONSUMERS * (t.qt + 1)) : n_k;
        const int qb = n & 1;
        // the consumers are done with the Q of tile n - 2, in this buffer
        if (n >= 2) mbar_wait(&q_empty[qb], ((n >> 1) - 1) & 1);
        // a 64-row tile wholly past L is not loaded
        const int q_tiles = min(FWD_CONSUMERS, (L - q0 + TILE_ROWS - 1) / TILE_ROWS);
        mbar_expect_tx(&q_full[qb], q_tiles * S::TILE);
        for (int c = 0; c < q_tiles; ++c) {
          tma_load_tile(base_u + S::Q + (qb * FWD_CONSUMERS + c) * S::TILE, &tq, &q_full[qb], t.h,
                        q0 + c * TILE_ROWS, t.b);
        }
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int stage = it % FWD_STAGES;
          if (it >= FWD_STAGES) mbar_wait(&empty[stage], (it / FWD_STAGES - 1) & 1);
          mbar_expect_tx(&full[stage], 2 * S::TILE);
          tma_load_tile(base_u + S::K + stage * S::TILE, &tk, &full[stage], t.h,
                        kt * TILE_ROWS, t.b);
          tma_load_tile(base_u + S::V + stage * S::TILE, &tv, &full[stage], t.h,
                        kt * TILE_ROWS, t.b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FWD_CONSUMER_REGS));
  const int c = wg - 1;             // this consumer's 64 rows of the q tile
  const int ti = threadIdx.x % WG_THREADS;
  const bool lead = threadIdx.x % 32 == 0;  // each warp's arrival on a barrier
  const float scale_log2e = scale * LOG2E;
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(base + S::OUT + c * S::OUT_TILE);

  float sa[32], sb[32];  // S of the current key tile and of the next
  float oacc[D / 2];
  uint32_t pf[4][4];  // P in bf16, as the A operand of the 4 steps of P.V
  float m[2], l[2];
  float shift[2];  // safe_m * log2(e) of the current tile: p = 2^(s * log2(e) - shift)
  float corr[2];   // the rescale of O and l that the next tile's max asks for

  int it = 0;
  int n = 0;
  for (int i = blockIdx.x; i < n_tiles; i += gridDim.x, ++n) {
    const QTile t = q_tile(i, H, BH, n_qt);
    const int q0 = t.qt * FWD_BQ + c * TILE_ROWS;  // this consumer's first row
    const int n_kt = causal ? min(n_k, FWD_CONSUMERS * (t.qt + 1)) : n_k;  // the block's
    // the key tiles up to this consumer's diagonal
    const int my_kt = q0 >= L ? 0 : (causal ? min(n_k, q0 / TILE_ROWS + 1) : n_k);

#pragma unroll
    for (int e = 0; e < D / 2; ++e) oacc[e] = 0.f;
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
    const int qb = n & 1;
    const uint64_t desc_q = desc_kmajor<D>(base_u + S::Q + (qb * FWD_CONSUMERS + c) * S::TILE);
    mbar_wait(&q_full[qb], (n >> 1) & 1);

    // issue S = Q . K^T of key tile kt into d, left in flight
    auto issue_s = [&](float (&d)[32], int kt) {
      const int stage = (it + kt) % FWD_STAGES;
      mbar_wait(&full[stage], ((it + kt) / FWD_STAGES) & 1);
      const uint64_t desc_k = desc_kmajor<D>(base_u + S::K + stage * S::TILE);
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(d, k_step_kmajor(desc_q, kk), k_step_kmajor(desc_k, kk), kk > 0);
      }
      wgmma_commit();
    };
    // issue O += P . V of key tile kt, left in flight
    auto issue_pv = [&](int kt) {
      const int stage = (it + kt) % FWD_STAGES;
      const uint64_t desc_v = desc_mnmajor<D>(base_u + S::V + stage * S::TILE);
      fence_regs(oacc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pf[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<D>(oacc, pf[kk], k_step_mnmajor<D>(desc_v, kk));
      }
      wgmma_commit();
    };
    // the softmax's first half on a finished S of key tile kt: the mask
    // (only a consumer's last key tile can need one), the rows' max folded
    // into m (scores are scaled inside the exponent: scale > 0 keeps the max);
    // sets shift and corr and rescales l
    auto softmax_max = [&](float (&s)[32], int kt, bool masked) {
      const int k0 = kt * TILE_ROWS;
      float cmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (masked && !key_live(q0 + acc_row(e), k0 + acc_col(e), L, causal)) {
          s[e] = -CUDART_INF_F;
        }
        cmax[(e >> 1) & 1] = fmaxf(cmax[(e >> 1) & 1], s[e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float safe_m;
        corr[r] = online_rescale(m[r], quad_max(cmax[r]) * scale, safe_m);
        l[r] *= corr[r];
        shift[r] = safe_m * LOG2E;
      }
    };
    // the second half: the exponentials, summed into l and rounded into P
    auto softmax_exp = [&](const float (&s)[32]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 8 * kk + 2 * j;
          const float p0 = exp2f(fmaf(s[e], scale_log2e, -shift[j & 1]));
          const float p1 = exp2f(fmaf(s[e + 1], scale_log2e, -shift[j & 1]));
          l[j & 1] += p0 + p1;  // the denominator sums P before rounding
          pf[kk][j] = pack_bf16(p0, p1);
        }
      }
    };
    auto rescale_o = [&]() {
#pragma unroll
      for (int e = 0; e < D / 2; ++e) oacc[e] *= corr[(e >> 1) & 1];
    };
    // one key tile kt whose S is in sa, not the last: S of kt + 1 is issued
    // into sb before this tile's exponentials and waited for (wait_group 1)
    // while this tile's P.V runs, under which the next tile's max is taken; O
    // is rescaled only when no product is in flight
    auto step = [&](int kt, bool mask_next) {
      issue_s(sb, kt + 1);
      softmax_exp(sa);
      issue_pv(kt);
      wgmma_wait_one();
      fence_regs(sb);
      softmax_max(sb, kt + 1, mask_next);
      wgmma_wait_all();
      fence_regs(oacc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pf[kk]);
      if (lead) mbar_arrive(&empty[(it + kt) % FWD_STAGES]);
      rescale_o();
#pragma unroll
      for (int e = 0; e < 32; ++e) sa[e] = sb[e];
    };

    if (my_kt > 0) {
      // the causal diagonal, or the ragged edge, lies in the last key tile
      const bool mask_last = causal || my_kt * TILE_ROWS > L;
      issue_s(sa, 0);
      wgmma_wait_all();
      fence_regs(sa);
      softmax_max(sa, 0, my_kt == 1 && mask_last);  // O is still zero: no rescale
      int kt = 0;
      for (; kt + 2 < my_kt; ++kt) step(kt, false);
      if (kt + 1 < my_kt) step(kt++, mask_last);
      if (lead) mbar_arrive(&q_empty[qb]);  // every S has read Q
      softmax_exp(sa);
      issue_pv(kt);
      wgmma_wait_all();
      fence_regs(oacc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pf[kk]);
      if (lead) mbar_arrive(&empty[(it + kt) % FWD_STAGES]);
    } else if (lead) {
      mbar_arrive(&q_empty[qb]);  // no row of this consumer lies before L
    }
    // the block's K/V tiles this consumer does not need: wait for each to land
    // (so the arrival counts toward its own phase), then free it
    for (int kt = my_kt; kt < n_kt; ++kt) {
      const int stage = (it + kt) % FWD_STAGES;
      mbar_wait(&full[stage], ((it + kt) / FWD_STAGES) & 1);
      if (lead) mbar_arrive(&empty[stage]);
    }
    it += n_kt;

    if (my_kt > 0) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        inv[r] = 1.f / fmaxf(l[r], 1e-20f);
        const int row = q0 + acc_row(2 * r);
        if (ti % 4 == 0 && row < L) lse[(long long)t.bh * L + row] = row_lse(m[r], l[r]);
      }
      wg_sync(1 + c);  // the previous tile's stores have read the staging tile
      stage_acc<D>(st, oacc, inv);
      wg_sync(1 + c);
      store_tile_wg<D>(o, so, st, t.b, t.h, q0, L, ti);
    }
  }
}

template <int D>
cudaError_t launch_fwd(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                       void* o, void* lse, int B, int H, int L, Strides so, int causal,
                       float scale, cudaStream_t stream) {
  // + slack to align the base; and more than half the SM's shared memory, so
  // one block per SM, as the register split of setmaxnreg assumes
  constexpr int need = FwdSmem<D>::BYTES + 1024;
  constexpr int smem = need > FWD_SMEM_ONE_BLOCK ? need : FWD_SMEM_ONE_BLOCK;
  const auto kernel = flash_fwd_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int n_tiles = B * H * ((L + FWD_BQ - 1) / FWD_BQ);
  const int grid = n_tiles < sms ? n_tiles : sms;  // persistent: one block per SM
  kernel<<<grid, FWD_THREADS, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o),
                                               static_cast<float*>(lse), H, B * H, L, so, causal,
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
