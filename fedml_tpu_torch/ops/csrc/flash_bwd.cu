// Flash-attention backward for Hopper (sm_90a) in fp32: dQ, and dK with dV,
// every product on the tensor cores in split TF32.
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
// Two kernels and no atomics, as the JAX package has two pallas_calls: no two
// blocks write the same row.
//
// Products: split TF32 on mma.sync m16n8k8 (flash_tf32.cuh, the forward's
// split): three TF32 products per fp32 product, fp32 sums.
//
// What bounds them on an H100 (3.35 TB/s; fp32-exact products at the 3xTF32
// rate, 495 / 3 = 165 TFLOP/s):
// - slice_train (B 32, L 80, H 8, D 32, causal): dQ moves 13.3 MB for 0.16
//   GFLOP, dK/dV 15.9 MB for 0.21 GFLOP, so bytes: 4.0 and 4.7 us;
// - bench_fp32 (B 8, L 1024, H 16, D 64, causal): dQ does 25.8 GFLOP and
//   dK/dV 34.4 GFLOP, 156 and 208 us, against 50 and 60 us of bytes, so
//   operations.  As in the forward, each mma.sync comes with the splits of
//   its B operand and two shared-memory loads, so a warp issues about as
//   many instructions as its products take tensor-core clocks.
//
// Design, dQ (flash_bwd_dq_kernel), the forward's shape: a warp owns 16
// query rows and a block 4 warps (64 rows) of one (b, h); blocks run the
// heaviest causal q tile first.  Q and dO stay in shared memory, read as A
// fragments and split per 8-deep step (held in registers, they took ptxas to
// 245 registers at D 64, and K3 to a spill), each row's LSE and delta in
// registers.  K and V tiles of 32 keys stream through a 2-stage ring of
// 16-byte cp.async copies (64-key tiles at D 32 made slice_train's dQ 1.35x
// slower: ops/variants.py, set fp32_bwd).  Per tile a warp forms
// S = Q.K^T and dP = dO.V^T (16 x 32 accumulators), P and dS in place
// (block_grads), and dQ += dS.K with dS taken straight from the accumulator
// as the A operand, the keys in the permuted order (a_from_acc).
//
// Design, dK/dV (flash_bwd_dkv_kernel), the transposed products, so that keys
// are the rows of every accumulator: a warp owns 16 keys and a block 4 warps
// (64 keys); blocks run the heaviest causal key tile (the first) first.  K
// and V stay in shared memory, read as dQ reads Q and dO.  Q, dO, LSE and
// delta tiles of 32 queries stream through the ring, from the block's first
// key on when causal.  Per tile a warp forms S^T = K.Q^T and dP^T = V.dO^T
// (16 x 32), P^T and dS^T in place, and dV += P^T.dO, dK += dS^T.Q with P^T
// and dS^T as the A operands.
//
// Both: rows are padded to D + 4 floats, which keeps every fragment load
// free of bank conflicts both ways a streamed tile is read (along D as the
// B operand of S, along rows as the B operand of the gradient's product:
// banks 4g + t and 8t + g).  Only a tile that holds the causal diagonal or
// the ragged edge tests liveness, per 8-wide column and per element; a warp
// skips the columns it cannot see, and a warp whose rows all lie past L only
// feeds the ring.  Gradients are written from the fragments, 8 bytes a
// thread.  The wrapper raises on views whose base or (b, l, h) strides are
// not 16-byte aligned.

#include "flash_tf32.cuh"

namespace flash {
namespace tf32 {

constexpr int ROWS = 16 * WARPS;  // rows each block owns: queries (dQ) or keys (dK/dV)

// Shared memory of both kernels: the block's own rows of two tensors (q and
// dO, or k and v), then the ring of streamed tiles of N rows of two tensors
// (k and v, or q and dO) and, for dK/dV, of the streamed rows' lse and delta.
template <int D>
struct BwdTile {
  static constexpr int N = 32;                 // rows a streamed tile
  static constexpr int LD = D + 4;             // row pitch in floats
  static constexpr int OWN0 = 0;               // float offsets
  static constexpr int OWN1 = ROWS * LD;
  static constexpr int RING0 = 2 * ROWS * LD;        // stage s at RING0 + s * N * LD
  static constexpr int RING1 = RING0 + STAGES * N * LD;
  static constexpr int LSE = RING1 + STAGES * N * LD;  // stage s at LSE + s * N
  static constexpr int DELTA = LSE + STAGES * N;
  static constexpr int FLOATS_DQ = LSE;
  static constexpr int FLOATS_DKV = DELTA + STAGES * N;
};

// The A fragment of 8-deep step kk of a warp's 16 rows, read from shared
// memory (row 0 at r, LD floats apart), standard order.
template <int LD>
__device__ __forceinline__ void a_frag(const float* r, int g, int t, int kk, float (&a)[4]) {
  r += g * LD + 8 * kk + t;
  a[0] = r[0];
  a[1] = r[8 * LD];
  a[2] = r[4];
  a[3] = r[8 * LD + 4];
}

// Write a warp's 16 x D accumulator to rows row0 + g and row0 + g + 8 of one
// (b, h) slice, skipping rows at or past L.
template <int D>
__device__ __forceinline__ void store_acc(float* __restrict__ dst, Strides s, int b, int h,
                                          int row0, int L, int g, int t,
                                          const float (&acc)[D / 8][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row < L) {
      float* out = dst + (long long)b * s.b + (long long)row * s.l + (long long)h * s.h + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
}

// s += A . X^T and dp += A2 . Y^T over a streamed tile's 8-row column tiles
// (rows of X and Y at xs and ys, LD apart), for the columns `want` admits:
// the two score products of a tile, depth outer so that the column tiles'
// independent sums interleave.  The warp's own rows of A and A2 (at a_rows,
// a2_rows) are read and split per step: held in registers, split or not,
// they would leave too few for the accumulators at D 64.
template <int D, int LD, int NT, bool ALL, class Want>
__device__ __forceinline__ void score_products(const float* a_rows, const float* a2_rows,
                                               const float* xs, const float* ys, int g, int t,
                                               Want want, float (&s)[NT][4],
                                               float (&dp)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    float a[4], a2[4];
    uint32_t ab[4], as[4], a2b[4], a2s[4];
    a_frag<LD>(a_rows, g, t, kk, a);
    a_frag<LD>(a2_rows, g, t, kk, a2);
    split4(a, ab, as);
    split4(a2, a2b, a2s);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (ALL || want(j)) {
        const float* xr = xs + (8 * j + g) * LD + 8 * kk + t;
        const float* yr = ys + (8 * j + g) * LD + 8 * kk + t;
        mma_3xtf32(s[j], ab, as, xr[0], xr[4]);
        mma_3xtf32(dp[j], a2b, a2s, yr[0], yr[4]);
      }
    }
  }
}

// acc += P . X over the 8-row steps `want` admits: P (16 x 8 NT, an
// accumulator) as the A operand in the permuted order, X's rows at xs (LD
// apart) as the B operand, rows 2t and 2t + 1 of each step.
template <int D, int LD, int NT, bool ALL, class Want>
__device__ __forceinline__ void grad_product(const float (&p)[NT][4], const float* xs, int g,
                                             int t, Want want, float (&acc)[D / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    if (ALL || want(kk)) {
      float a[4];
      uint32_t ab[4], as[4];
      a_from_acc(p[kk], a);
      split4(a, ab, as);
      const float* xr = xs + (8 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) mma_3xtf32(acc[j], ab, as, xr[8 * j], xr[LD + 8 * j]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int L, Strides sq, Strides sk, Strides sv,
                        Strides sdo, Strides sdq, int causal, float scale) {
  using T = BwdTile<D>;
  constexpr int BK = T::N;
  constexpr int LD = T::LD;
  constexpr int NT = BK / 8;  // 8-key column tiles of S
  constexpr int KD = D / 8;   // 8-deep steps of S; 8-column tiles of dQ
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // the heaviest causal q tile first
  const int r0 = q0 + 16 * warp;                       // this warp's first row
  const bool live = r0 < L;
  // keys this warp needs, and the block's K/V tiles
  const int k_end = causal ? min(L, r0 + 16) : L;
  const int n_kt = ((causal ? min(L, q0 + ROWS) : L) + BK - 1) / BK;

  load_tile<D, ROWS>(smem + T::OWN0, LD, q, sq, b, h, q0, L);
  load_tile<D, ROWS>(smem + T::OWN1, LD, dout, sdo, b, h, q0, L);
  cp_async_commit();
  load_tile<D, BK>(smem + T::RING0, LD, k, sk, b, h, 0, L);
  load_tile<D, BK>(smem + T::RING1, LD, v, sv, b, h, 0, L);
  cp_async_commit();
  float lse_r[2], delta_r[2];  // rows r0 + g and r0 + g + 8; -inf LSE past L gives P = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    lse_r[r] = row < L ? lse[(long long)bh * L + row] : -CUDART_INF_F;
    delta_r[r] = row < L ? delta[(long long)bh * L + row] : 0.f;
  }
  cp_async_wait<1>();  // Q and dO have landed (read by every tile's products)
  __syncthreads();

  const float* qa = smem + T::OWN0 + 16 * warp * LD;  // this warp's rows of q and dO
  const float* da = smem + T::OWN1 + 16 * warp * LD;
  float acc[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt % STAGES;
    if (kt + 1 < n_kt) {  // the next tile's copies overlap this tile's products
      const int nxt = (kt + 1) % STAGES;
      load_tile<D, BK>(smem + T::RING0 + nxt * BK * LD, LD, k, sk, b, h, (kt + 1) * BK, L);
      load_tile<D, BK>(smem + T::RING1 + nxt * BK * LD, LD, v, sv, b, h, (kt + 1) * BK, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed for every thread

    const int k0 = kt * BK;
    if (live && k0 < k_end) {
      const float* ks = smem + T::RING0 + stage * BK * LD;
      const float* vs = smem + T::RING1 + stage * BK * LD;
      // only the tile holding this warp's diagonal or the ragged edge tests
      const bool masked = (causal && k0 + BK - 1 > r0) || k0 + BK > L;
      const auto want = [&](int j) { return k0 + 8 * j < k_end; };
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
      if (masked) {
        score_products<D, LD, NT, false>(qa, da, ks, vs, g, t, want, s, dp);
      } else {
        score_products<D, LD, NT, true>(qa, da, ks, vs, g, t, want, s, dp);
      }
      // dS in place of S
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = r0 + g + 8 * (e >> 1);
          const bool on = !masked || (want(j) && key_live(row, key, L, causal));
          float p;
          block_grads(s[j][e] * scale, dp[j][e], lse_r[e >> 1], delta_r[e >> 1], on, scale, p,
                      s[j][e]);
        }
      }
      if (masked) {
        grad_product<D, LD, NT, false>(s, ks, g, t, want, acc);
      } else {
        grad_product<D, LD, NT, true>(s, ks, g, t, want, acc);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if (live) store_acc<D>(dq, sdq, b, h, r0, L, g, t, acc);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int L,
                         Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, int causal, float scale) {
  using T = BwdTile<D>;
  constexpr int BQ = T::N;
  constexpr int LD = T::LD;
  constexpr int NT = BQ / 8;  // 8-query column tiles of S^T
  constexpr int KD = D / 8;   // 8-deep steps of S^T; 8-column tiles of dK and dV
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * ROWS;  // key tile 0, the heaviest when causal, first
  const int c0 = k0 + 16 * warp;     // this warp's first key
  const bool live = c0 < L;
  // causal: a query before the block's first key sees none of its keys
  const int q_begin = causal ? k0 : 0;
  const int n_qt = (L - q_begin + BQ - 1) / BQ;
  const float* lse_bh = lse + (long long)bh * L;
  const float* delta_bh = delta + (long long)bh * L;

  load_tile<D, ROWS>(smem + T::OWN0, LD, k, sk, b, h, k0, L);
  load_tile<D, ROWS>(smem + T::OWN1, LD, v, sv, b, h, k0, L);
  cp_async_commit();
  load_tile<D, BQ>(smem + T::RING0, LD, q, sq, b, h, q_begin, L);
  load_tile<D, BQ>(smem + T::RING1, LD, dout, sdo, b, h, q_begin, L);
  load_stat<BQ>(smem + T::LSE, lse_bh, q_begin, L, -CUDART_INF_F);  // P = 0 past L
  load_stat<BQ>(smem + T::DELTA, delta_bh, q_begin, L, 0.f);
  cp_async_commit();
  cp_async_wait<1>();  // K and V have landed (read by every tile's products)
  __syncthreads();

  const float* ka = smem + T::OWN0 + 16 * warp * LD;  // this warp's keys of k and v
  const float* va = smem + T::OWN1 + 16 * warp * LD;
  float dka[KD][4], dva[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }

  for (int it = 0; it < n_qt; ++it) {
    const int stage = it % STAGES;
    const int q0 = q_begin + it * BQ;
    if (it + 1 < n_qt) {  // the next tile's copies overlap this tile's products
      const int nxt = (it + 1) % STAGES;
      load_tile<D, BQ>(smem + T::RING0 + nxt * BQ * LD, LD, q, sq, b, h, q0 + BQ, L);
      load_tile<D, BQ>(smem + T::RING1 + nxt * BQ * LD, LD, dout, sdo, b, h, q0 + BQ, L);
      load_stat<BQ>(smem + T::LSE + nxt * BQ, lse_bh, q0 + BQ, L, -CUDART_INF_F);
      load_stat<BQ>(smem + T::DELTA + nxt * BQ, delta_bh, q0 + BQ, L, 0.f);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it has landed for every thread

    if (live && (!causal || q0 + BQ - 1 >= c0)) {
      const float* qs = smem + T::RING0 + stage * BQ * LD;
      const float* dos = smem + T::RING1 + stage * BQ * LD;
      const float* lses = smem + T::LSE + stage * BQ;
      const float* deltas = smem + T::DELTA + stage * BQ;
      // only the tile holding this warp's diagonal or a ragged edge tests
      const bool masked = (causal && q0 < c0 + 15) || q0 + BQ > L || c0 + 16 > L;
      // an 8-query column this warp can see: inside L and, when causal, not
      // wholly before its first key
      const auto want = [&](int j) {
        return q0 + 8 * j < L && (!causal || q0 + 8 * j + 7 >= c0);
      };
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
      if (masked) {
        score_products<D, LD, NT, false>(ka, va, qs, dos, g, t, want, s, dp);
      } else {
        score_products<D, LD, NT, true>(ka, va, qs, dos, g, t, want, s, dp);
      }
      // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lses + 8 * j + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(deltas + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int query = q0 + 8 * j + 2 * t + (e & 1);
          const int key = c0 + g + 8 * (e >> 1);
          const bool on = !masked || (want(j) && key_live(query, key, L, causal));
          block_grads(s[j][e] * scale, dp[j][e], (e & 1) ? l2.y : l2.x, (e & 1) ? d2.y : d2.x,
                      on, scale, s[j][e], dp[j][e]);
        }
      }
      if (masked) {
        grad_product<D, LD, NT, false>(s, dos, g, t, want, dva);
        grad_product<D, LD, NT, false>(dp, qs, g, t, want, dka);
      } else {
        grad_product<D, LD, NT, true>(s, dos, g, t, want, dva);
        grad_product<D, LD, NT, true>(dp, qs, g, t, want, dka);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if (live) {
    store_acc<D>(dk, sdk, b, h, c0, L, g, t, dka);
    store_acc<D>(dv, sdv, b, h, c0, L, g, t, dva);
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int H, int L,
                      const long long* st, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = BwdTile<D>::FLOATS_DQ * 4;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + ROWS - 1) / ROWS);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
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
  constexpr int smem = BwdTile<D>::FLOATS_DKV * 4;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + ROWS - 1) / ROWS);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), H, L,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), causal, scale);
  return cudaGetLastError();
}

}  // namespace tf32
}  // namespace flash

// fp32 only; D: 32 or 64.  strides: 15 int64, the (b, l, h) element strides of
// q, k, v, dO and dq; q, k, v and dO each with a 16-byte aligned base and
// strides that are multiples of 4 (16-byte copies), dq 8-byte aligned with
// even strides.  lse and delta contiguous [B, H, L].  Returns the launch's
// cudaError_t.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int B, int H, int L,
                            int D, int causal, float scale, const void* strides, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 32) {
    err = flash::tf32::launch_dq<32>(q, k, v, dout, lse, delta, dq, B, H, L, st, causal, scale, s);
  } else if (D == 64) {
    err = flash::tf32::launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, L, st, causal, scale, s);
  }
  return static_cast<int>(err);
}

// fp32 only; D: 32 or 64.  strides: 18 int64, the (b, l, h) element strides of
// q, k, v, dO, dk and dv; the alignment of flash_bwd_dq, dk and dv as dq.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                             int L, int D, int causal, float scale, const void* strides,
                             void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 32) {
    err = flash::tf32::launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, B, H, L, st, causal,
                                      scale, s);
  } else if (D == 64) {
    err = flash::tf32::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, L, st, causal,
                                      scale, s);
  }
  return static_cast<int>(err);
}
