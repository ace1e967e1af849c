// Hopper building blocks of the bf16 flash-attention kernels (flash_fwd_sm90.cu,
// flash_dq_sm90.cu, flash_dkv_sm90.cu, flash_update_sm90.cu): TMA tile loads into shared memory guarded by mbarriers,
// wgmma matrix descriptors for the swizzled tiles TMA writes, the wgmma
// instructions the kernels issue, and the host-side tensor maps.
//
// Tiles.  Every tile is 64 rows of one (b, h) slice of a [B, L, H, D] bf16
// tensor: the box (D, 1, 64, 1) of a 4-D tensor map over (D, H, L, B) with the
// tensor's own strides, so fused-qkv views load as they are.  Rows past L are
// zero-filled by TMA.  A row is D * 2 bytes: 128 at D 64, stored with the
// 128-byte swizzle; 64 at D 32, with the 64-byte swizzle.  Each tile starts on
// a 1024-byte boundary, so the swizzle TMA applies is the one the wgmma
// descriptor names.
//
// Fragments.  A warpgroup (4 warps, 128 threads) owns a 64-row accumulator.
// Thread (warp w, lane) holds, for each 8-column chunk j, the elements
// (16w + lane/4, 8j + 2(lane%4) + {0, 1}) in d[4j + {0, 1}] and the same
// columns of row + 8 in d[4j + {2, 3}] (acc_row / acc_col below).  Rounded to
// bf16 pairs, the elements 8kk..8kk+7 of an accumulator are exactly the four
// A-operand registers of the kk-th 16-deep step of a product that takes the
// accumulator as its left operand, so P and dS never pass through
// shared memory.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {
namespace sm90 {

constexpr int TILE_ROWS = 64;   // rows of every tile: one wgmma M tile
constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int OUT_PAD = 8;       // bf16 elements of padding per staged output row

// ---------------------------------------------------------------------------
// shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------
// The first 1024-byte boundary at or after p (the dynamic allocation carries
// 1024 bytes of slack for it).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more of TMA traffic before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase `parity` has completed.  A phase that never
// completes is a bug (a load never issued, a byte count that does not match):
// after about 2^26 polls, seconds of waiting, the kernel traps instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 26)) asm volatile("trap;\n");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: copy rows [row, row + 64) of head h of batch b into the tile at
// shared address dst; completion is counted on bar.
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                              int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so the compiler
// neither moves their other uses across the fence/wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Matrix descriptors of a tile of 64 rows of D bf16 (row pitch D * 2 bytes),
// swizzled as TMA wrote it: 128-byte swizzle at D 64, 64-byte at D 32.  The
// tile's row is one swizzle atom wide, and the stride between groups of 8
// rows is 8 * D * 2 bytes.  As a K-major operand (the rows run along M or N,
// the 16 elements of a step lie in one row) that stride is the descriptor's
// stride offset and the leading offset is one 16-byte unit.  As an MN-major
// operand (the rows run along K, D along N) the 8-row groups step along K;
// the offset between atoms along N is never used at these widths, so both
// offsets are set to the group stride.
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint64_t lead) {
  static_assert(D == 32 || D == 64, "head dims 32 and 64");
  constexpr uint64_t layout = D == 64 ? 1 : 2;  // 1: 128-byte swizzle, 2: 64-byte
  constexpr uint64_t group = (8 * D * 2) >> 4;  // in 16-byte units
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (lead << 16) | (group << 32) |
         (layout << 62);
}
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return make_desc<D>(addr, 1);
}
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return make_desc<D>(addr, (8 * D * 2) >> 4);
}
// Advance a descriptor along K by 16 elements: 32 bytes within a row of a
// K-major tile; 16 rows of an MN-major tile.
__device__ __forceinline__ uint64_t k_step_kmajor(uint64_t desc, int kk) {
  return desc + static_cast<uint64_t>(kk * 2);
}
template <int D>
__device__ __forceinline__ uint64_t k_step_mnmajor(uint64_t desc, int kk) {
  return desc + static_cast<uint64_t>(kk * ((16 * D * 2) >> 4));
}

// The products accumulate, D += A . B (the predicate scale-d is always set).
// D[64 x 64] += A[64 x 16] . B[16 x 64], A and B from shared memory (K-major).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b) {
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
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (four bf16 pairs a
// thread), B from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A from registers, B MN-major.
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// acc[64 x D] += A[64 x 16] . B[16 x D], B an MN-major [rows][D] tile.
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == 64) {
    wgmma_m64n64k16_rs(d, a, desc_b);
  } else {
    wgmma_m64n32k16_rs(d, a, desc_b);
  }
}

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------
// Row and column, inside the 64-row tile, of accumulator element i of this thread.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x / 32 % 4) + (threadIdx.x % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Write a 64 x D fp32 accumulator, row r scaled by mul[r] (r = 0: the thread's
// upper row, 1: the lower), as bf16 into a staging tile of pitch D + OUT_PAD.
template <int D>
__device__ __forceinline__ void stage_acc(__nv_bfloat16* st, const float (&acc)[D / 2],
                                          const float (&mul)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const float f = mul[(i >> 1) & 1];
    *reinterpret_cast<uint32_t*>(st + acc_row(i) * (D + OUT_PAD) + acc_col(i)) =
        pack_bf16(acc[i] * f, acc[i + 1] * f);
  }
}

// Copy a staged tile to rows [row0, row0 + 64) of one (b, h) slice, 16 bytes a
// thread at a time, skipping rows at or past L.
template <int D>
__device__ __forceinline__ void store_tile(__nv_bfloat16* __restrict__ dst, Strides s,
                                           const __nv_bfloat16* st, int b, int h, int row0,
                                           int L) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < TILE_ROWS * CHUNKS; c += WG_THREADS) {
    const int r = c / CHUNKS;
    const int cc = c - r * CHUNKS;
    if (row0 + r < L) {
      *reinterpret_cast<uint4*>(dst + (long long)b * s.b + (long long)(row0 + r) * s.l +
                                (long long)h * s.h + cc * 8) =
          *reinterpret_cast<const uint4*>(st + r * (D + OUT_PAD) + cc * 8);
    }
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------
// Status codes the C entry points return besides a cudaError_t.
constexpr int ERR_NO_ENCODER = -1;   // the CUDA driver has no cuTensorMapEncodeTiled
constexpr int ERR_TENSOR_MAP = -2;   // the CUDA driver refused a tensor's layout

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The CUDA driver's cuTensorMapEncodeTiled, found through the runtime so that no
// -lcuda is needed.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The 64-row tile map of one bf16 [B, L, H, D] tensor with element strides s
// (the D stride is 1).  Returns 0 or an ERR_ code.
inline int make_tile_map(CUtensorMap* map, const void* ptr, int B, int L, int H, int D,
                         Strides s) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.l * 2, (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)TILE_ROWS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

}  // namespace sm90
}  // namespace flash
