// Flash-attention forward for Hopper (sm_90a), fp32: O and the per-row LSE,
// every product on the tensor cores in split TF32.
//
// Replaces: fedml_tpu/ops/flash_attention.py:_flash_kernel (the Pallas TPU
// kernel launched by _flash_forward) for fp32 inputs; bf16 inputs take
// flash_fwd_sm90.cu.  Same function: scores = q.k^T / sqrt(D) with keys at or
// past L masked and, when causal, keys after the row masked; online softmax
// in fp32; O = softmax . V; LSE in fp32 (-inf for a row with no live key).
//
// Products.  A TF32 operand keeps 10 of fp32's 23 mantissa bits, too few for
// the fp32 tolerances.  Each fp32 operand x is split into big, x rounded to
// TF32, and small = x - big, which keep about 21 bits between them, and each
// product is three TF32 products summed in fp32: small.big + big.small
// first, then big.big; small.small, 2^-22 of the product, is dropped.  The
// same route as the fp32 path of PyTorch's memory-efficient attention
// (CUTLASS's OpMultiplyAddFastF32).  Products are mma.sync m16n8k8 TF32:
// wgmma takes TF32 operands only K-major, and V [keys, D] is MN-major for
// P.V, so wgmma would need a transposed copy of every V tile; mma.sync lets
// each thread load its own fragments from one padded layout.  The
// exponentials are exp2 of the log2(e)-scaled scores, as in the bf16 kernels.
//
// What bounds it on an H100 (3.35 TB/s; fp32-exact products at the 3xTF32
// rate, 495 / 3 = 165 TFLOP/s):
// - slice_train (B 32, L 80, H 8, D 32, causal): 10.6 MB moved (q, k, v read
//   once, O and LSE written once), 3.2 us, against 0.11 GFLOP of live pairs,
//   0.6 us: bytes, below a launch's own overhead;
// - slice_eval (B 256): 84.6 MB, 25.2 us, against 5.1 us: bytes;
// - bench_fp32 (B 8, L 1024, H 16, D 64, causal): 17.2 GFLOP, 104 us, against
//   134 MB, 40 us: operations.  Each mma.sync comes with its operands'
//   splits (three integer and float instructions an element, no
//   conversion) and shared-memory loads, so a warp issues nearly as many
//   instructions as its products take tensor-core clocks.
//
// Design: a warp owns 16 query rows and a block 4 warps (64 rows) of one
// (b, h); blocks run the heaviest causal q tile first.  Q is split once
// into big and small fragments held in registers for the whole loop.  K and
// V tiles of BK keys stream through a 2-stage ring of 16-byte cp.async
// copies (rows past L zero-filled), so the next tile's load overlaps this
// tile's products; K rows are padded to D + 8 floats and V rows to D + 4, so
// every fragment load is free of bank conflicts.  Per tile a warp computes
// S = Q.K^T (16 x BK), the online softmax on the accumulator fragment (row
// max and sum over the quad by shuffles), splits P and adds P.V into its
// 16 x D accumulator.  The warp takes the key columns of P.V in the order
// its S fragment holds them (keys 2t, 2t + 1 of each 8 as the A operand's
// columns t, t + 4), so P never leaves registers, and S's depth in the same
// order, so K and Q fragments load as pairs.  A causal warp stops at its own
// last row, rounded up to 8 keys; a warp whose rows all lie past L only
// feeds the ring.  The ragged edge is masked in the kernel, so nothing is
// padded or transposed outside it.  O is written from the fragments, 8 bytes
// a thread, a quad covering 32 contiguous bytes of a row.  The wrapper
// raises on views whose base or (b, l, h) strides are not 16-byte aligned.

#include "flash_common.cuh"

namespace flash {
namespace tf32 {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block
constexpr int STAGES = 2;

// keys per K/V tile: 32 at D 64, 64 at D 32 (the same bytes a tile)
template <int D>
struct Tile {
  static constexpr int BK = D == 64 ? 32 : 64;
  static constexpr int LDQ = D + 8;  // Q and K: 8-byte fragment loads, conflict free
  static constexpr int LDK = D + 8;
  static constexpr int LDV = D + 4;  // V: 4-byte loads two keys apart, conflict free
  static constexpr int Q = 0;                      // float offsets in shared memory
  static constexpr int K = BQ * LDQ;               // stage s at K + s * BK * LDK
  static constexpr int V = K + STAGES * BK * LDK;  // stage s at V + s * BK * LDV
  static constexpr int FLOATS = V + STAGES * BK * LDV;
};

// 16 bytes from global to shared memory, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Queue the copy of rows [row0, row0 + ROWS) of one (b, h) slice into shared
// memory ld floats apart; rows at or past L are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          Strides s, int b, int h, int row0, int L) {
  constexpr int CHUNKS = D / 4;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS;
    const int cc = c - r * CHUNKS;
    const bool valid = row0 + r < L;
    const float* g = valid ? src + (long long)b * s.b + (long long)(row0 + r) * s.l +
                                 (long long)h * s.h + cc * 4
                           : src;
    cp_async16(dst + r * ld + cc * 4, g, valid);
  }
}

// fp32 -> (big, small) TF32 parts, x = big + small to about 21 bits.  big is
// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32's
// rounding, done as an integer add and mask: two full-rate instructions, not
// a conversion); small = x - big is exact in fp32 and goes to the tensor
// cores as it is, which read a TF32 operand's top 19 bits (small truncated:
// 2^-10 of small, about 2^-21 of x).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d[16 x 8] += a[16 x 8] . b[8 x 8], TF32 operands, fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b with fp32 operands given as TF32 parts: the two correction
// products first, then big . big.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], uint32_t b_big0,
                                           uint32_t b_big1, uint32_t b_small0,
                                           uint32_t b_small1) {
  mma_tf32(d, a_small, b_big0, b_big1);
  mma_tf32(d, a_big, b_small0, b_small1);
  mma_tf32(d, a_big, b_big0, b_big1);
}

// Fragments (g = lane / 4, t = lane % 4): an accumulator d[16 x 8] holds
// (g, 2t + {0, 1}) in d[0], d[1] and (g + 8, 2t + {0, 1}) in d[2], d[3].  The
// A operand of a 16 x 8 step takes its columns t and t + 4 from the source's
// columns 2t and 2t + 1, and the B operand its rows t and t + 4 likewise: a
// permutation of the summed index, the same on both sides.
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int L, Strides sq, Strides sk, Strides sv,
                     Strides so, int causal, float scale) {
  using T = Tile<D>;
  constexpr int BK = T::BK;
  constexpr int NT = BK / 8;  // 8-key column tiles of S
  constexpr int KD = D / 8;   // 8-deep steps of S; 8-column tiles of O
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the heaviest causal q tile first
  const int r0 = q0 + 16 * warp;                      // this warp's first row
  const bool live = r0 < L;
  // keys this warp needs, and the block's K/V tiles
  const int k_end = causal ? min(L, r0 + 16) : L;
  const int n_kt = ((causal ? min(L, q0 + BQ) : L) + BK - 1) / BK;

  load_tile<D, BQ>(smem + T::Q, T::LDQ, q, sq, b, h, q0, L);
  cp_async_commit();
  load_tile<D, BK>(smem + T::K, T::LDK, k, sk, b, h, 0, L);
  load_tile<D, BK>(smem + T::V, T::LDV, v, sv, b, h, 0, L);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // Q as the A operand of S's KD steps, split once
  uint32_t qb[KD][4], qs[KD][4];
  {
    const float* qr = smem + T::Q + (16 * warp + g) * T::LDQ + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const float2 lo = *reinterpret_cast<const float2*>(qr + 8 * kk);
      const float2 hi = *reinterpret_cast<const float2*>(qr + 8 * T::LDQ + 8 * kk);
      split(lo.x, qb[kk][0], qs[kk][0]);
      split(hi.x, qb[kk][1], qs[kk][1]);
      split(lo.y, qb[kk][2], qs[kk][2]);
      split(hi.y, qb[kk][3], qs[kk][3]);
    }
  }

  float acc[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's denominator

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt % STAGES;
    if (kt + 1 < n_kt) {  // the next tile's copies overlap this tile's products
      const int nxt = (kt + 1) % STAGES;
      load_tile<D, BK>(smem + T::K + nxt * BK * T::LDK, T::LDK, k, sk, b, h, (kt + 1) * BK, L);
      load_tile<D, BK>(smem + T::V + nxt * BK * T::LDV, T::LDV, v, sv, b, h, (kt + 1) * BK, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed for every thread

    const int k0 = kt * BK;
    if (live && k0 < k_end) {
      const float* ks = smem + T::K + stage * BK * T::LDK;
      const float* vs = smem + T::V + stage * BK * T::LDV;
      // S = Q . K^T over the 8-key column tiles this warp needs, depth outer
      // so that the column tiles' independent sums interleave
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
      const float* kr = ks + g * T::LDK + 2 * t;
      auto s_step = [&](int j, int kk) {
        const float2 kv = *reinterpret_cast<const float2*>(kr + 8 * j * T::LDK + 8 * kk);
        uint32_t bb0, bs0, bb1, bs1;
        split(kv.x, bb0, bs0);
        split(kv.y, bb1, bs1);
        mma_3xtf32(s[j], qb[kk], qs[kk], bb0, bb1, bs0, bs1);
      };
      if (k0 + BK <= k_end) {  // the whole tile is live for this warp: no branch
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
          for (int j = 0; j < NT; ++j) s_step(j, kk);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (k0 + 8 * j < k_end) s_step(j, kk);
          }
        }
      }
      // online softmax over this tile
      const bool masked = (causal && k0 + BK - 1 > r0) || k0 + BK > L;
      float cmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = r0 + g + 8 * (e >> 1);
          float x = s[j][e] * scale;
          if (k0 + 8 * j >= k_end || (masked && !key_live(row, key, L, causal))) {
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
      // P, then O += P . V over the key steps this warp needs
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        if (k0 + 8 * kk < k_end) {
          uint32_t pb[4], ps[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(fmaf(s[kk][e], LOG2E, -shift[e >> 1]));  // masked: 2^-inf = 0
            l[e >> 1] += p;
            // accumulator (e) -> A operand: e 0, 1, 2, 3 -> a0, a2, a1, a3
            const int a = ((e & 1) << 1) | (e >> 1);
            split(p, pb[a], ps[a]);
          }
          const float* vr = vs + (8 * kk + 2 * t) * T::LDV + g;
#pragma unroll
          for (int j = 0; j < KD; ++j) {
            uint32_t bb0, bs0, bb1, bs1;
            split(vr[8 * j], bb0, bs0);
            split(vr[T::LDV + 8 * j], bb1, bs1);
            mma_3xtf32(acc[j], pb, ps, bb0, bb1, bs0, bs1);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    const int row = r0 + g + 8 * r;
    if (row < L) {
      const float denom = fmaxf(l[r], 1e-20f);
      float* orow = o + (long long)b * so.b + (long long)row * so.l + (long long)h * so.h + 2 * t;
#pragma unroll
      for (int j = 0; j < KD; ++j) {
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(acc[j][2 * r] / denom, acc[j][2 * r + 1] / denom);
      }
      if (t == 0) lse[(long long)bh * L + row] = row_lse(m[r], l[r]);
    }
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int H, int L, const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int smem = Tile<D>::FLOATS * 4;
  const auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), H, L, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), causal, scale);
  return cudaGetLastError();
}

}  // namespace tf32
}  // namespace flash

// fp32 only; D: 32 or 64.  strides: 12 int64, the (b, l, h) element strides of
// q, k, v and o; q, k and v each with a 16-byte aligned base and strides that
// are multiples of 4 (16-byte copies), o 8-byte aligned with even strides.
// Returns the launch's cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                         int H, int L, int D, int causal, float scale, const void* strides,
                         void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 32) {
    err = flash::tf32::launch_fwd<32>(q, k, v, o, lse, B, H, L, st, causal, scale, s);
  } else if (D == 64) {
    err = flash::tf32::launch_fwd<64>(q, k, v, o, lse, B, H, L, st, causal, scale, s);
  }
  return static_cast<int>(err);
}
