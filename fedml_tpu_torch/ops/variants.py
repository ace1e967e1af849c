"""Time variants of a kernel on the card: the tree's source with text
replaced, built beside the tree's library and timed in turns with it.

    python -m fedml_tpu_torch.ops.variants [SET ...] [--trace]

Each variant of a set is a list of (old, new) replacements in one source of
``csrc/`` (or (file, old, new) in another file of ``csrc/``, a header it
includes); every ``old`` must occur exactly once.  The tree's kernels run first
and last, each variant between, at the cases of its source (the shapes of
``chip_smoke.py``'s phase 2 and, for the bf16 forward, its non-causal twin;
for the fp32 shard fold, phase 2's fp32 folds); a backward source times each
of its kernels.  With
``--trace`` the bf16 forward is built with clock64 probes at the steps of a
consumer's key loop (block 0, first q tile) and the cycles between them are
printed.  Needs a CUDA card and nvcc; results go to ``variants/`` beside
``chip_smoke.py``'s own output directory.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Tuple

BF16_SRC = "flash_fwd_sm90.cu"
FP32_SRC = "flash_fwd.cu"
BWD_SRC = "flash_bwd.cu"
FOLD_SRC = "flash_update.cu"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (name, B, L, H, D, dtype, causal); for the fold, the names of chip_smoke.py's
# FOLD_CASES
CASES = {
    BF16_SRC: [("bench_bf16", 8, 1024, 16, 64, "bfloat16", True),
               ("bench_full", 8, 1024, 16, 64, "bfloat16", False)],
    FP32_SRC: [("slice_train", 32, 80, 8, 32, "float32", True),
               ("slice_eval", 256, 80, 8, 32, "float32", True),
               ("bench_fp32", 8, 1024, 16, 64, "float32", True)],
    BWD_SRC: [("slice_train", 32, 80, 8, 32, "float32", True),
              ("ragged_full", 4, 50, 8, 32, "float32", False),
              ("bench_fp32", 8, 1024, 16, 64, "float32", True)],
    FOLD_SRC: [("fold_past_fp32",), ("fold_diagonal_fp32",), ("fold_dead_fp32",),
               ("fold_permuted_fp32",), ("fold_ragged_full",)],
}

_STEP = "      issue_s(sb, kt + 1);\n      softmax_exp(sa);\n"
_SEQ = (_STEP, "      softmax_exp(sa);\n      issue_s(sb, kt + 1);\n")
_THREE = [("constexpr int FWD_CONSUMERS = 2;", "constexpr int FWD_CONSUMERS = 3;"),
          ("constexpr int FWD_PRODUCER_REGS = 40;\nconstexpr int FWD_CONSUMER_REGS = 232;",
           "constexpr int FWD_PRODUCER_REGS = 24;\nconstexpr int FWD_CONSUMER_REGS = 160;")]


def _stages(n: int) -> Tuple[str, str]:
    return "constexpr int FWD_STAGES = 4;", f"constexpr int FWD_STAGES = {n};"


# Ping-pong: the consumers take turns (named barriers 3 and 4, each counting
# the waiting and the handing warpgroup) at a region of every key tile, so
# that one's region runs while the other's does not; a consumer with fewer
# key tiles than the block takes its turns empty-handed.
_TURNS = """// ping-pong turns between the two consumers
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, %1;\\n" ::"r"(3 + c), "n"(2 * WG_THREADS) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, %1;\\n" ::"r"(3 + (c + 1) % 2), "n"(2 * WG_THREADS) : "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {"""


def _ping_pong(region: str) -> List[Tuple[str, str]]:
    """The turn taken around the exponentials ("exp") or around the S issue,
    the exponentials and the P.V issue ("products")."""
    if region == "exp":
        step = ("      softmax_exp(sa);\n      issue_pv(kt);\n      wgmma_wait_one();\n",
                "      turn_wait(c);\n      softmax_exp(sa);\n      turn_pass(c);\n"
                "      issue_pv(kt);\n      wgmma_wait_one();\n")
    else:
        step = ("      issue_s(sb, kt + 1);\n      softmax_exp(sa);\n      issue_pv(kt);\n",
                "      turn_wait(c);\n      issue_s(sb, kt + 1);\n      softmax_exp(sa);\n"
                "      issue_pv(kt);\n      turn_pass(c);\n")
    return [
        ("__device__ __forceinline__ void wgmma_wait_one() {", _TURNS),
        ("  const float scale_log2e = scale * LOG2E;\n",
         "  const float scale_log2e = scale * LOG2E;\n  if (c == 1) turn_pass(c);\n"),
        step,
        ("      softmax_exp(sa);\n      issue_pv(kt);\n      wgmma_wait_all();\n",
         "      turn_wait(c);\n      softmax_exp(sa);\n      issue_pv(kt);\n      turn_pass(c);\n"
         "      wgmma_wait_all();\n"),
        ("      if (lead) mbar_arrive(&empty[stage]);\n    }\n",
         "      if (lead) mbar_arrive(&empty[stage]);\n      turn_wait(c);\n      turn_pass(c);\n"
         "    }\n"),
    ]


def _bounds(kernel: str, blocks: int) -> Tuple[str, str]:
    return (f"__launch_bounds__(THREADS)\n    {kernel}(",
            f"__launch_bounds__(THREADS, {blocks})\n    {kernel}(")


_BWD_TILE = "static constexpr int N = 32; "
_TF32_H = "flash_tf32.cuh"
_CORRECTIONS = ("  mma_tf32(d, a_small, b_big0, b_big1);\n"
                "  mma_tf32(d, a_big, b_small0, b_small1);\n")
_SPLIT_B = "  split(b0, b_big0, b_small0);\n  split(b1, b_big1, b_small1);\n"
_FOLD_TILE = "static constexpr int BK = D == 64 ? 32 : 64;"
_Q_FIRST = [("  const bool rows = r0 < Lq;                          // the warp has a row inside Lq\n",
             "  const bool rows = r0 < Lq;\n"
             "  load_tile<D, BQ>(smem + T::Q, T::LDQ, q, sq, b, h, q0, Lq);\n"
             "  cp_async_commit();\n"),
            ("  if (n_it > 0) {\n    load_tile<D, BQ>(smem + T::Q, T::LDQ, q, sq, b, h, q0, Lq);\n"
             "    cp_async_commit();\n",
             "  if (n_it == 0) cp_async_wait<0>();\n  if (n_it > 0) {\n")]
# the fold's first design: Q's fragments split once into registers and held
# for the whole fold (the tree reads them from shared memory at each 8-deep
# step of S and splits them there)
_Q_SPLIT = """    const float* qr = smem + T::Q + (16 * warp + g) * T::LDQ + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const float2 lo = *reinterpret_cast<const float2*>(qr + 8 * kk);
      const float2 hi = *reinterpret_cast<const float2*>(qr + 8 * T::LDQ + 8 * kk);
      split(lo.x, qb[kk][0], qs[kk][0]);
      split(hi.x, qb[kk][1], qs[kk][1]);
      split(lo.y, qb[kk][2], qs[kk][2]);
      split(hi.y, qb[kk][3], qs[kk][3]);
    }
"""
_Q_REGISTERS = [("  if (n_it > 0) {\n    load_tile<D, BQ>",
                 "  uint32_t qb[KD][4], qs[KD][4];\n  if (n_it > 0) {\n    load_tile<D, BQ>"),
                ("    cp_async_wait<1>();  // Q has landed\n    __syncthreads();\n",
                 "    cp_async_wait<1>();  // Q has landed\n    __syncthreads();\n" + _Q_SPLIT),
                ("""      const float* qr = smem + T::Q + (16 * warp + g) * T::LDQ + 2 * t;
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
          mma_3xtf32(s[j], qb, qs, kv.x, kv.y);""",
                 """#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(kr + 8 * j * T::LDK + 8 * kk);
          mma_3xtf32(s[j], qb[kk], qs[kk], kv.x, kv.y);""")]
# two shortcuts from the positions: each live tile's least live position and
# greatest position (INT_MAX when it holds padding) kept beside the list; a
# warp skips a tile whose least live position lies after its latest row, and
# skips the live test on a tile without padding whose greatest position lies
# at or before its least row
_SHORTCUTS = [
    ("  int* tiles = reinterpret_cast<int*>(smem + T::WORDS);\n",
     "  int* tiles = reinterpret_cast<int*>(smem + T::WORDS);\n"
     "  int* top = tiles + n_kt;\n  int* lows = top + n_kt;\n"),
    ("  const int smem = 4 * (T::WORDS + n_kt);", "  const int smem = 4 * (T::WORDS + 3 * n_kt);"),
    ("""    int least = INT_MAX;
#pragma unroll
    for (int i = 0; i < BK / 32; ++i) {
      const int key = kt * BK + 32 * i + lane;
      const int kp = key < Lk ? k_pos[key] : -1;
      if (kp >= 0) least = min(least, kp);
    }
    least = __reduce_min_sync(0xffffffffu, least);
    if (lane == 0) tiles[kt] = least;
""", """    int least = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int i = 0; i < BK / 32; ++i) {
      const int key = kt * BK + 32 * i + lane;
      const int kp = key < Lk ? k_pos[key] : -1;
      if (kp >= 0) least = min(least, kp);
      hi = max(hi, kp >= 0 ? kp : INT_MAX);
    }
    least = __reduce_min_sync(0xffffffffu, least);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      tiles[kt] = least;
      top[kt] = hi;
    }
"""),
    ("  if (lane == 0) warp_last[warp] = last;\n",
     "  if (lane == 0) warp_last[warp] = last;\n  int q_lo = INT_MAX;\n"
     "  for (int r = 0; r < 2; ++r) if (r0 + g + 8 * r < Lq) q_lo = min(q_lo, qp[r]);\n"
     "  q_lo = __reduce_min_sync(0xffffffffu, q_lo);\n"),
    ("      const int least = kt < n_kt ? tiles[kt] : INT_MAX;\n",
     "      const int least = kt < n_kt ? tiles[kt] : INT_MAX;\n"
     "      const int hi = kt < n_kt ? top[kt] : INT_MAX;\n"),
    ("      if (keep) tiles[n + __popc(kept & ((1u << lane) - 1u))] = kt;\n",
     "      if (keep) {\n        const int at = n + __popc(kept & ((1u << lane) - 1u));\n"
     "        tiles[at] = kt;\n        top[at] = hi;\n        lows[at] = least;\n      }\n"),
    ("    if (rows) {\n",
     "    if (rows && (!causal || lows[it] <= last)) {\n"
     "      const bool all_live = top[it] != INT_MAX && (!causal || top[it] <= q_lo);\n"),
    ("          if (!key_live_at(", "          if (!all_live && !key_live_at("),
]
# the fold's launch bound without its minimum of 4 blocks an SM
_FOLD_UNCAPPED = ("__launch_bounds__(THREADS, 4)\n    flash_update_kernel(",
                  "__launch_bounds__(THREADS)\n    flash_update_kernel(")
_UNSPLIT_B = ("  b_big0 = __float_as_uint(b0);\n  b_big1 = __float_as_uint(b1);\n"
              "  b_small0 = b_small1 = 0u;\n")

# the variants of the bf16 forward measured for PERF.md: the next tile's S
# issued after the exponentials (not in flight), ping-pong between the
# consumers, three consumer warpgroups (192-row q tiles) with and without S
# in flight, and other ring depths
SETS: Dict[str, List[Tuple[str, str, List[Tuple[str, str]]]]] = {
    "bf16": [("s_after_exp", BF16_SRC, [_SEQ]),
             ("ping_pong_exp", BF16_SRC, _ping_pong("exp")),
             ("ping_pong_products", BF16_SRC, _ping_pong("products")),
             ("three_consumers", BF16_SRC, _THREE),
             ("three_consumers_s_after_exp", BF16_SRC, _THREE + [_SEQ]),
             ("stages_2", BF16_SRC, [_stages(2)]),
             ("stages_6", BF16_SRC, [_stages(6)])],
    # the fp32 backward: registers capped for 4 blocks an SM; streamed tiles
    # of 64 rows at D 32 (the first design's), or of 16 at both head dims;
    # dQ's q tiles in grid order rather than the heaviest first
    "fp32_bwd": [("four_blocks", BWD_SRC, [_bounds("flash_bwd_dq_kernel", 4),
                                           _bounds("flash_bwd_dkv_kernel", 4)]),
                 ("tile_64_at_32", BWD_SRC, [(_BWD_TILE,
                                              "static constexpr int N = D == 64 ? 32 : 64; ")]),
                 ("tile_16", BWD_SRC, [(_BWD_TILE, "static constexpr int N = 16; ")]),
                 # diagnostics, not the kernels' function: one TF32 product
                 # (the correction products removed), and B operands taken
                 # unsplit (big = x, small = 0): what the products and the
                 # splits of B cost
                 ("one_product", BWD_SRC, [(_TF32_H, _CORRECTIONS, "")]),
                 ("b_unsplit", BWD_SRC, [(_TF32_H, _SPLIT_B, _UNSPLIT_B)]),
                 ("dq_grid_order", BWD_SRC, [(
                     "const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;",
                     "const int q0 = blockIdx.y * ROWS;")])],
    # the fp32 shard fold: the first design (Q split in registers, 167
    # registers, 3 blocks an SM), and it capped for 4 blocks an SM; the tree
    # without its launch bound's minimum of 4 blocks an SM (ptxas then takes
    # fewer registers); 64-key tiles at D 64 (2 blocks an SM by shared memory,
    # uncapped); with two shortcuts taken from the positions (a warp skips a
    # tile none of its rows sees, and the live test where every key of the
    # tile is live for every row of the warp); q tiles in grid order; the Q tile's copy queued before the position
    # pre-pass (also on a dead fold); and the diagnostic of one TF32 product
    "fold_fp32": [("q_in_registers", FOLD_SRC, _Q_REGISTERS + [_FOLD_UNCAPPED]),
                  ("q_in_registers_capped", FOLD_SRC, _Q_REGISTERS),
                  ("uncapped", FOLD_SRC, [_FOLD_UNCAPPED]),
                  ("tile_64", FOLD_SRC, [(_FOLD_TILE, "static constexpr int BK = 64;"),
                                         _FOLD_UNCAPPED]),
                  ("position_shortcuts", FOLD_SRC, _SHORTCUTS),
                  ("grid_order", FOLD_SRC, [(
                      "const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;",
                      "const int q0 = blockIdx.y * BQ;")]),
                  ("q_first", FOLD_SRC, _Q_FIRST),
                  ("one_product", FOLD_SRC, [(_TF32_H, _CORRECTIONS, "")])],
}

# clock64 probes at the steps of the bf16 forward's key loop
_TRACE_HEAD = """
__device__ unsigned long long g_trace[2 * 4 * 64 * 8];
#define TR(kt, ev) if (blockIdx.x == 0 && n == 0 && (kt) >= 0 && (kt) < 64 && threadIdx.x % 32 == 0) \\
  g_trace[((c * 4 + (threadIdx.x / 32) % 4) * 64 + (kt)) * 8 + (ev)] = clock64();
"""
_TRACE = [
    ('#include "flash_sm90.cuh"\n', '#include "flash_sm90.cuh"\n' + _TRACE_HEAD),
    ("    auto issue_s = [&](float (&d)[32], int kt) {\n"
     "      const int stage = (it + kt) % FWD_STAGES;\n"
     "      mbar_wait(&full[stage], ((it + kt) / FWD_STAGES) & 1);\n",
     "    auto issue_s = [&](float (&d)[32], int kt) {\n"
     "      const int stage = (it + kt) % FWD_STAGES;\n"
     "      mbar_wait(&full[stage], ((it + kt) / FWD_STAGES) & 1);\n"
     "      TR(kt - 1, 1);\n"),
    ("      issue_s(sb, kt + 1);\n      softmax_exp(sa);\n      issue_pv(kt);\n"
     "      wgmma_wait_one();\n      fence_regs(sb);\n      softmax_max(sb, kt + 1, mask_next);\n"
     "      wgmma_wait_all();\n",
     "      TR(kt, 0);\n      issue_s(sb, kt + 1);\n      TR(kt, 2);\n      softmax_exp(sa);\n"
     "      TR(kt, 3);\n      issue_pv(kt);\n      TR(kt, 4);\n      wgmma_wait_one();\n"
     "      fence_regs(sb);\n      TR(kt, 5);\n      softmax_max(sb, kt + 1, mask_next);\n"
     "      TR(kt, 6);\n      wgmma_wait_all();\n      TR(kt, 7);\n"),
]
# the cycles between consecutive probes of a step
TRACE_EVENTS = ("wait for the K/V tile", "issue S (4 wgmma)", "exponentials", "issue P.V",
                "wait for S", "row max", "wait for P.V")
_READ_TRACE = """
extern "C" int read_trace(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
"""


def build_variants(variants, root: str) -> Dict[str, str]:
    """Copy csrc/ per variant into ``root``, apply its replacements, build
    each with the tree's nvcc flags, all at once.  Returns {name: library}."""
    from . import build

    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, source, reps in variants:
        d = os.path.join(root, name)
        shutil.copytree(build.CSRC, os.path.join(d, "csrc"))
        path = os.path.join(d, "csrc", source)
        for rep in reps:
            edit, old, new = rep if len(rep) == 3 else (source, *rep)
            edit_path = os.path.join(d, "csrc", edit)
            with open(edit_path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: {old[:60]!r} occurs {text.count(old)} times")
            with open(edit_path, "w") as f:
                f.write(text.replace(old, new))
        lib = os.path.join(d, f"lib{name}.so")
        procs[name] = (subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib, path],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{log[-3000:]}")
        for kernel, u in build.ptxas_usage(log).items():
            print(f"  {name}: {build.kernel_label(kernel)} {u}", flush=True)
        libs[name] = lib
    return libs


def _bind(source: str, lib: str = None) -> None:
    """Bind the tree's kernels, with ``source``'s library replaced by ``lib``."""
    from . import build

    builds = build.build()  # the tree's libraries, built before
    if lib is not None:
        builds[source] = {"path": lib}
    build._LIBRARY[:] = [build.KernelLibrary(builds)]


def _inputs(B, L, H, D, dtype):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1234)
    qkv = (torch.randn(B, L, 3, H, D, generator=gen, device="cuda") * 0.5).to(
        getattr(torch, dtype))
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _fold_calls(case):
    """[("fold", call, max |kernel - plain| of o)] at one of chip_smoke.py's
    fold cases."""
    import chip_smoke as cs

    from . import flash_attention as fa

    row = next(r for r in cs.FOLD_CASES if r[0] == case)
    args = cs.fold_args(fa, *row[1:])
    err = (fa.flash_shard_update_cuda(*args)[2] - fa.flash_shard_update_plain(*args)[2]).abs()
    return [("fold", lambda: fa.flash_shard_update_cuda(*args), float(err.max()))]


def _calls(source, case, B=None, L=None, H=None, D=None, dtype=None, causal=None):
    """[(kernel, call, max |kernel - plain|)] of a source's kernels at one case."""
    import torch

    from . import flash_attention as fa

    if source == FOLD_SRC:
        return _fold_calls(case)
    q, k, v = _inputs(B, L, H, D, dtype)
    if source != BWD_SRC:
        o, _ = fa.flash_forward_cuda(q, k, v, causal)
        err = (o.float() - fa.flash_forward_plain(q, k, v, causal)[0].float()).abs().max()
        return [("forward", lambda: fa.flash_forward_cuda(q, k, v, causal), float(err))]
    gen = torch.Generator(device="cuda").manual_seed(4321)
    do = (torch.randn(B, L, H, D, generator=gen, device="cuda") * 0.5).to(q.dtype)
    o, lse = fa.flash_forward_plain(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, delta, causal)
    dq_err = (fa.flash_bwd_dq_cuda(*args) - fa.flash_bwd_dq_plain(*args)).abs().max()
    dkv_err = max((a - b).abs().max() for a, b in zip(fa.flash_bwd_dkv_cuda(*args),
                                                      fa.flash_bwd_dkv_plain(*args)))
    return [("dQ", lambda: fa.flash_bwd_dq_cuda(*args), float(dq_err)),
            ("dK/dV", lambda: fa.flash_bwd_dkv_cuda(*args), float(dkv_err))]


def time_variants(variants) -> list:
    """Rows (variant, case, kernel, ms, max |out - plain|): the tree first and
    last."""
    import torch

    sys.path.insert(0, _ROOT)
    import chip_smoke as cs

    libs = build_variants(variants, os.path.join(_ROOT, "build", "variants"))
    sources = sorted({source for _, source, _ in variants})
    order = [(f"tree {s}", s, None) for s in sources]
    order += [(name, source, libs[name]) for name, source, _ in variants]
    order += [(f"tree {s}", s, None) for s in sources]
    rows = []
    for name, source, lib in order:
        _bind(source, lib)
        for case in CASES[source]:
            for kernel, call, err in _calls(source, *case):
                ms = cs.time_ms(call, 10 if "bench" in case[0] else 30)
                rows.append((name, case[0], kernel, ms, err))
                print(f"  {name:30s} {case[0]:18s} {kernel:8s} {ms:.4f} ms  max |out - plain| "
                      f"{err:.3e}", flush=True)
            torch.cuda.empty_cache()
    _bind(sources[0])
    return rows


def trace_bf16(steps: int = 6):
    """Cycles between the probes of the bf16 forward's steps, for the first
    ``steps`` key tiles of each consumer warp 0 (block 0, bench shape)."""
    import numpy as np
    import torch

    from . import flash_attention as fa

    root = os.path.join(_ROOT, "build", "variants_trace")
    lib = build_variants([("trace", BF16_SRC, _TRACE + [("\nextern \"C\" int flash_fwd_sm90(",
                                                         _READ_TRACE + "\nextern \"C\" int "
                                                         "flash_fwd_sm90(")])], root)["trace"]
    _bind(BF16_SRC, lib)
    q, k, v = _inputs(8, 1024, 16, 64, "bfloat16")
    for _ in range(3):
        fa.flash_forward_cuda(q, k, v, True)
    torch.cuda.synchronize()
    from . import build

    buf = (ctypes.c_ulonglong * (2 * 4 * 64 * 8))()
    rc = build._LIBRARY[0]._dlls[BF16_SRC].read_trace(ctypes.cast(buf, ctypes.c_void_p))
    if rc:
        raise RuntimeError(f"read_trace: cudaError_t {rc}")
    t = np.array(buf, dtype=np.int64).reshape(2, 4, 64, 8)
    out = []
    for c in range(2):
        for kt in range(1, steps + 1):  # kt 0 has no probe 1 (the prologue's S)
            row = t[c, 0, kt]
            if not row.all():
                continue
            cycles = [int(row[i + 1] - row[i]) for i in range(7)]
            out.append({"consumer": c, "kt": kt, "cycles": dict(zip(TRACE_EVENTS, cycles)),
                        "step": int(t[c, 0, kt + 1, 0] - row[0]) if t[c, 0, kt + 1, 0] else None})
            print(f"  consumer {c} key tile {kt:2d}: " + ", ".join(
                f"{e} {n}" for e, n in zip(TRACE_EVENTS, cycles))
                + f"; step {out[-1]['step']}", flush=True)
    _bind(BF16_SRC)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = {}
    names = [a for a in argv if not a.startswith("--")]
    for name in names:
        out[name] = time_variants(SETS[name])
    if "--trace" in argv:
        out["trace"] = trace_bf16()
    sys.path.insert(0, _ROOT)
    import chip_smoke

    out_dir = os.path.join(os.path.dirname(chip_smoke.OUT_DIR), "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
