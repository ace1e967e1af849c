#!/usr/bin/env python3
"""Drive the PyTorch port (fedml_tpu_torch) on one CUDA card, in phases.

    python3 chip_smoke.py

1. Device and build: the card's name and power limit, torch/CUDA versions,
   the TF32 flags; then the CUDA kernels are built with nvcc from
   fedml_tpu_torch/ops/csrc (one nvcc per source, in parallel), and ptxas's
   registers and spills of every kernel instantiation are logged: a spill in
   a kernel of NO_SPILL fails the phase.
2. Kernels: each flash-attention kernel (forward, dQ, dK/dV; in bf16 the
   tensor-core kernels; the fp32 forward, dQ and dK/dV on the tensor cores
   in split TF32) against its plain PyTorch version on the same
   inputs, at the slice's shapes (B 32 and, for the eval forward, B 256;
   L 80, H 8, D 32, fp32, causal), a ragged non-causal case (L 50) and the
   TransformerLM bench shape (B 8, L 1024, H 16, D 64) in bf16 and fp32,
   with the tolerances below.  Then ring
   attention's shard fold (K4) against its plain twin at the sequence-
   parallel slice's fold (B 8, Lq = Lk 256, H 16, D 64): the three kinds of
   fold a causal ring makes (keys before the rows, the diagonal, keys after
   the rows) in bf16 and fp32, ragged non-causal folds with padded keys in
   fp32 and (D 32) bf16, and a bf16 diagonal fold whose key positions are a
   seeded permutation.
   Kernel, plain version and, where one PyTorch call computes the same
   function, that call (F.scaled_dot_product_attention, its efficient-
   attention backward and, in bf16, its flash-attention backward: yardsticks
   only, the port never calls them) are timed on the device with CUDA events
   around a queue of calls, median of trials (``time_ms``).  The bench_bf16
   rows of K1-K3 and their yardsticks are printed on a line of their own.
3. Reference: one FedAvg round of a small TransformerLM on the card
   (kernels) and on the CPU (plain versions) from the same seed must agree;
   so must one SGD step of a small sequence-parallel TransformerLM (sp 4).
4. Slice 1: FedAvg of the full-width hub TransformerLM on shakespeare
   (100 clients, 10 per round, 3 rounds) through fedml_tpu_torch.init ->
   data.load -> models.hub.create -> FedMLRunner(...).run(), with every
   kernel's launch count read just after the run.
5. Profile: torch.profiler over one client's local training, after the
   main path's counts were read: device-busy share and the top kernels.
6. Slice 2: the sequence-parallel TransformerLM at bench.py's TransformerLM
   width (d_model 1024, 8 layers, 16 heads x 64, d_ff 4096, vocab 32000,
   B 8 x L 1024, sp 4) through create_mesh -> sp_init -> sp_apply ->
   sp_loss_fn with make_optimizer's SGD: fp32 logits held to the single-card
   model's (flash attention, K1), then one warm and 3 timed bf16 SGD steps,
   with the launch counts read just after: the fp32 forward launches the fp32
   K4 128 times, each bf16 forward the bf16 K4 128 times, and nothing else.
7. Single card: bench.py's TransformerLM leg (_measure_transformer,
   bench.py:1465-1502) on one card: the same width and B 8 x L 1024, bf16
   compute over fp32 params, SGD lr 1e-3, the TransformerLM with its default
   flash attention, through the engine's loss (build_loss_fn) and
   make_optimizer: one warm and 3 timed steps, each launching exactly 8 K1,
   8 K2 and 8 K3 (the bf16 tensor-core kernels) and no K4, then one step
   under torch.profiler.
8. The kernels line, the card line, and the last line
   {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero with no result line.  It
exits 2 when no CUDA device is visible.  Full details go to
chiprun_out/chip_smoke/ beside this script.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# the least time for a product of the input type: bf16 dense on the tensor
# cores; fp32-exact products as split TF32, three TF32 products for each fp32
# one on the tensor cores (495 TFLOP/s / 3), the route of the fp32 forward and
# backward (csrc/flash_tf32.cuh) and of PyTorch's fp32 memory-efficient
# attention; 67
# TFLOP/s, fp32 outside the tensor cores, would be the scalar route's
PEAK_OPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
# tolerance per dtype: |kernel - plain| <= atol + rtol * |plain|, elementwise.
# fp32: the two sum in another order; the products of the forward, dQ and
# dK/dV are split TF32 (about 21 bits of each operand;
# tests/test_torch_split_tf32.py), the shard fold's fp32 FMAs, the plain
# versions' fp32 (no TF32).
# bf16: outputs are rounded to bf16 (2^-8 relative), and the forward rounds P
# against its running max where the plain version uses the row max, so one
# bf16 step either way on the larger entries: rtol takes a few such steps.
# atol is what entries near zero may differ by, small against the values
# compared: at the bench shape a typical |dK| is about 1e-2 and |O| about
# 2e-2, so an error confined to some key tiles cannot hide under it.  Each
# check records the least atol it would pass with (``least_atol``).  On an
# H100 at the bench shape that read 3.6e-4 for K1 and 1.0e-4 for K3 (dV), and
# 8.3e-2 for a planted K3 fault wrong only past the first key tile
# (tests/test_torch_flash_cuda.py): atol 1e-3 sits between them.
# The shard fold (K4) keeps fp32 state on both sides, so m and l take the
# fp32 row-statistic tolerances in both types; its o is unnormalised, so its
# rounding error grows with the row's denominator l, and its atol is scaled
# by max(l, 1).  In bf16 the fold's o has a tolerance of its own, its rtol
# tighter than O's: the kernel and its plain twin round P to bf16 against
# maxima that differ only where a row spans several key tiles, and o stays
# fp32, unrounded.  On an H100 the largest |o - plain| / max(l, 1)
# read 2.8e-4 on the past fold and 1.1e-3 on the diagonal one, where a row
# of a few keys can see one P one bf16 step apart (o / l then moves by up to
# 2^-8 |v|): atol 3e-3 leaves room over that reading.  The tensor-core fold
# reads up to 2.0e-3 on a diagonal fold with permuted key positions.
TOLERANCE = {
    "float32": {"o": (2e-5, 1e-5), "lse": (1e-5, 1e-6), "grad": (1e-4, 1e-4),
                "m": (1e-5, 1e-6), "l": (1e-5, 1e-5), "fold_o": (2e-5, 1e-5)},
    "bfloat16": {"o": (1e-3, 2e-2), "lse": (1e-4, 1e-5), "grad": (1e-3, 3e-2),
                 "m": (1e-5, 1e-6), "l": (1e-5, 1e-5), "fold_o": (3e-3, 1e-2)},
}
# the kernels line: (kernel, which is also its launch counter, source, TPU
# kernel it replaces, phase-2 case of record)
_TPU = "fedml_tpu/ops/flash_attention.py"
KERNELS = [
    ("flash_fwd", "fedml_tpu_torch/ops/csrc/flash_fwd.cu", f"{_TPU}:56 _flash_kernel",
     "slice_train"),
    ("flash_fwd_sm90", "fedml_tpu_torch/ops/csrc/flash_fwd_sm90.cu", f"{_TPU}:56 _flash_kernel",
     "bench_bf16"),
    ("flash_bwd_dq", "fedml_tpu_torch/ops/csrc/flash_bwd.cu",
     f"{_TPU}:211 _flash_bwd_dq_kernel", "slice_train"),
    ("flash_dq_sm90", "fedml_tpu_torch/ops/csrc/flash_dq_sm90.cu",
     f"{_TPU}:211 _flash_bwd_dq_kernel", "bench_bf16"),
    ("flash_bwd_dkv", "fedml_tpu_torch/ops/csrc/flash_bwd.cu",
     f"{_TPU}:245 _flash_bwd_dkv_kernel", "slice_train"),
    ("flash_dkv_sm90", "fedml_tpu_torch/ops/csrc/flash_dkv_sm90.cu",
     f"{_TPU}:245 _flash_bwd_dkv_kernel", "bench_bf16"),
    ("flash_shard_update", "fedml_tpu_torch/ops/csrc/flash_update.cu",
     f"{_TPU}:427 _flash_update_kernel", "fold_past_fp32"),
    ("flash_update_sm90", "fedml_tpu_torch/ops/csrc/flash_update_sm90.cu",
     f"{_TPU}:427 _flash_update_kernel", "fold_past_bf16"),
]
# the kernels (ptxas entry names) that must not spill
NO_SPILL = ("flash_fwd_kernel", "flash_fwd_sm90_kernel", "flash_bwd_dq_kernel",
            "flash_dq_sm90_kernel", "flash_bwd_dkv_kernel", "flash_dkv_sm90_kernel",
            "flash_update_kernel", "flash_update_sm90_kernel")
SLICE1_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# (name, B, L, H, D, dtype, causal, functions to check: each runs the kernel
# of its dtype, named in the row by the counter that its launch moved)
CASES = [
    ("slice_train", 32, 80, 8, 32, "float32", True, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    ("slice_eval", 256, 80, 8, 32, "float32", True, ("flash_fwd",)),
    ("ragged_full", 4, 50, 8, 32, "float32", False, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    ("bench_bf16", 8, 1024, 16, 64, "bfloat16", True, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    ("bench_fp32", 8, 1024, 16, 64, "float32", True, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
]
# K4 at the sp slice's fold: (name, B, Lq, Lk, H, D, dtype, causal, q shard,
# k shard, padded key tail, key positions permuted).  With shards of Lq keys,
# q shard 1 folds shard 0 (all keys before the rows), itself (the diagonal)
# and shard 2 (all after: dead when causal); past and dead folds carry the
# diagonal fold's state.  The permuted fold takes the diagonal shard's
# positions in a seeded order, which the dead-tile skip must survive.
FOLD_CASES = [
    ("fold_past_bf16", 8, 256, 256, 16, 64, "bfloat16", True, 1, 0, 0, False),
    ("fold_diagonal_bf16", 8, 256, 256, 16, 64, "bfloat16", True, 1, 1, 0, False),
    ("fold_dead_bf16", 8, 256, 256, 16, 64, "bfloat16", True, 1, 2, 0, False),
    ("fold_permuted_bf16", 8, 256, 256, 16, 64, "bfloat16", True, 1, 1, 0, True),
    ("fold_ragged_bf16", 4, 200, 130, 8, 32, "bfloat16", False, 1, 0, 17, False),
    ("fold_past_fp32", 8, 256, 256, 16, 64, "float32", True, 1, 0, 0, False),
    ("fold_diagonal_fp32", 8, 256, 256, 16, 64, "float32", True, 1, 1, 0, False),
    ("fold_dead_fp32", 8, 256, 256, 16, 64, "float32", True, 1, 2, 0, False),
    ("fold_ragged_full", 4, 200, 130, 8, 32, "float32", False, 1, 0, 17, False),
]
# slice 2: bench.py's TransformerLM leg (bench.py:1465-1502), sequence-parallel
SP_CONFIG = dict(vocab_size=32000, d_model=1024, n_heads=16, n_layers=8, d_ff=4096)
SP_BATCH, SP_LEN, SP_SHARDS, SP_LR = 8, 1024, 4, 1e-3
# sp logits (ring, K4) against single-card logits (K1), fp32 with TF32 off:
# the two sum each row's keys in another order, through 8 layers
SP_PARITY_ATOL = 1e-3
SLICE_CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "shakespeare", "partition_method": "hetero", "partition_alpha": 0.5},
    "model_args": {"model": "transformer"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 100,
                   "client_num_per_round": 10, "comm_round": 3, "epochs": 1, "batch_size": 32,
                   "client_optimizer": "sgd", "learning_rate": 0.1},
    "validation_args": {"frequency_of_the_test": 1},
    "device_args": {"device_type": "gpu"},
    "comm_args": {"backend": "XLA"},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sleep_cycles_per_ms() -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def time_ms(fn, reps: int = 20, warmup: int = 3, trials: int = 5) -> float:
    """Device time of one call, the median over ``trials`` of CUDA events
    around ``reps`` calls over ``reps``.  A spin kernel queued ahead of the
    start event keeps the card busy while the host enqueues the calls, so
    the host's launch path (the wrapper, ctypes, the allocator) does not
    enter the time; if the spin ends before the host is done, it is
    lengthened and the trial repeated."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()  # enqueue time only: no synchronize before the clock is read
    spin_ms = 3.0 * reps * (time.perf_counter() - t0) * 1e3 + 1.0
    torch.cuda.synchronize()
    cycles_per_ms = _sleep_cycles_per_ms()
    per_call = []
    while len(per_call) < trials:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        starved = start.query()  # the spin ended before the last call was queued
        end.synchronize()
        if starved:
            if spin_ms > 60_000:
                raise RuntimeError("the host cannot queue the timed calls ahead of the card")
            spin_ms *= 4
            continue
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def _roofline(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(kernel: str, B: int, L: int, H: int, D: int, dtype: str, causal: bool):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (each input read once, each output written once) over HBM bandwidth and
    the operations its live (query, key) pairs need over the dtype's peak."""
    elt = 2 if dtype == "bfloat16" else 4
    tensor = B * L * H * D * elt
    row = B * H * L * 4  # an fp32 [B, H, L] row statistic
    pairs = B * H * (L * (L + 1) // 2 if causal else L * L)
    if kernel == "flash_fwd":  # q, k, v -> o, lse; q.k and p.v
        nbytes, ops = 4 * tensor + row, pairs * 4 * D
    elif kernel == "flash_bwd_dq":  # q, k, v, dO, lse, delta -> dq; q.k, dO.v, dS.k
        nbytes, ops = 5 * tensor + 2 * row, pairs * 6 * D
    else:  # q, k, v, dO, lse, delta -> dk, dv; q.k, dO.v, P^T.dO, dS^T.q
        nbytes, ops = 6 * tensor + 2 * row, pairs * 8 * D
    return _roofline(nbytes, ops, dtype)


def bound_fold(B: int, H: int, D: int, dtype: str, live):
    """K4's (bound_ms, bound_by), counted from this fold's [Lq, Lk] mask of
    live (query, key) pairs: the rows of q with a live key and the rows of k
    and v live for some query, read once in their type; the two int32
    position arrays; m and l in and out and o in and out in fp32 (every row
    of the state passes through); 4 D operations (q.k and p.v) per live
    pair."""
    Lq, Lk = live.shape
    elt = 2 if dtype == "bfloat16" else 4
    q_rows, kv_rows = int(live.any(1).sum().item()), int(live.any(0).sum().item())
    nbytes = (B * q_rows + 2 * B * kv_rows) * H * D * elt + 4 * (Lq + Lk) \
        + 4 * B * H * Lq * 4 + 2 * B * Lq * H * D * 4
    return _roofline(nbytes, B * H * int(live.sum().item()) * 4 * D, dtype)


def poison(*like) -> None:
    """Fill blocks the size of the coming outputs with NaN and free them, so
    the allocator hands NaN memory to the kernel's outputs: an output the
    kernel never writes then fails the finiteness check."""
    import torch

    blocks = [torch.full_like(t, float("nan")) for t in like]
    del blocks


def check_close(name: str, got, want, tol, scale=None):
    """|got - want| <= atol * scale + rtol * |want| elementwise (scale 1 by
    default); a value that is not finite passes only where it equals want's
    (a row with no live key keeps m = -inf), so a NaN never does.  Returns
    (max |got - want|, the least atol with which the check passes)."""
    atol, rtol = tol
    got, want = got.float(), want.float()
    same = got == want
    if not bool((got.isfinite() | same).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs().masked_fill(same, 0.0)
    least_atol = float(((err - rtol * want.abs()) / (1.0 if scale is None else scale))
                       .clamp_min(0.0).max().item())
    if least_atol > atol:
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} exceeds "
                             f"atol {atol}{' x max(l, 1)' if scale is not None else ''}"
                             f" + rtol {rtol} (it would pass with atol {least_atol:.3e})")
    return float(err.max().item()), least_atol


def worst(*checks):
    """(max |err|, least atol) over several checks' results."""
    return max(c[0] for c in checks), max(c[1] for c in checks)


def kernel_phase(fa):
    """Compare and time every kernel at every case; returns per-case rows."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rows = []
    for case, B, L, H, D, dtype_name, causal, functions in CASES:
        dtype = getattr(torch, dtype_name)
        tol = TOLERANCE[dtype_name]
        reps = 10 if L >= 1024 else 30
        gen = torch.Generator(device="cuda").manual_seed(1234)
        # q, k, v as views of one fused [B, L, 3, H, D] projection, as the model gives them
        qkv = (torch.randn(B, L, 3, H, D, generator=gen, device="cuda") * 0.5).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = (torch.randn(B, L, H, D, generator=gen, device="cuda") * 0.5).to(dtype)
        o_ref, lse_ref = fa.flash_forward_plain(q, k, v, causal)
        delta = (do.float() * o_ref.float()).sum(-1).permute(0, 2, 1).contiguous()
        case_rows = []
        for fn in functions:
            poison(do, do, lse_ref)
            before = dict(fa.LAUNCHES)
            if fn == "flash_fwd":
                o, lse = fa.flash_forward_cuda(q, k, v, causal)
                torch.cuda.synchronize()
                err = worst(check_close(f"{case} O", o, o_ref, tol["o"]),
                            check_close(f"{case} LSE", lse, lse_ref, tol["lse"]))
                run_k = lambda: fa.flash_forward_cuda(q, k, v, causal)
                run_p = lambda: fa.flash_forward_plain(q, k, v, causal)
            elif fn == "flash_bwd_dq":
                dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse_ref, delta, causal)
                torch.cuda.synchronize()
                dq_ref = fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)
                err = check_close(f"{case} dQ", dq, dq_ref, tol["grad"])
                run_k = lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse_ref, delta, causal)
                run_p = lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)
            else:
                dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta, causal)
                torch.cuda.synchronize()
                dk_ref, dv_ref = fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)
                err = worst(check_close(f"{case} dK", dk, dk_ref, tol["grad"]),
                            check_close(f"{case} dV", dv, dv_ref, tol["grad"]))
                run_k = lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta, causal)
                run_p = lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)
            moved = [n for n in fa.LAUNCHES if fa.LAUNCHES[n] != before[n]]
            if len(moved) != 1:
                raise AssertionError(f"{case} {fn}: launch counters moved {moved}")
            b_ms, b_by = bound(fn, B, L, H, D, dtype_name, causal)
            row = {"case": case, "kernel": moved[0], "shape": [B, L, H, D], "dtype": dtype_name,
                   "causal": causal, "max_abs_err": err[0], "least_atol": err[1],
                   "ms": time_ms(run_k, reps), "plain_ms": time_ms(run_p, reps),
                   "bound_ms": b_ms, "bound_by": b_by, "library": None, "library_ms": None}
            case_rows.append(row)
        # yardsticks, which the port never calls: SDPA's forward for the
        # forward; for the backward kernels SDPA's backward alone over a
        # retained graph, which computes dQ, dK and dV in one call: the
        # efficient-attention one and, in bf16, the flash-attention one
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        with torch.no_grad():
            sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), reps)
        bwd_ms = {}
        backends = [("efficient", SDPBackend.EFFICIENT_ATTENTION)]
        if dtype == torch.bfloat16:
            backends.append(("flash", SDPBackend.FLASH_ATTENTION))
        if "flash_bwd_dq" in functions:
            for label, backend in backends:
                with sdpa_kernel(backend):
                    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
                bwd_ms[label] = time_ms(lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True), reps)
                del out
        for row in case_rows:
            if row["kernel"] in ("flash_fwd", "flash_fwd_sm90"):
                row.update(library="sdpa forward", library_ms=sdpa_fwd_ms)
            elif bwd_ms:
                row.update(library="sdpa efficient-attention backward (dQ, dK, dV)",
                           library_ms=bwd_ms["efficient"],
                           sdpa_flash_bwd_ms=bwd_ms.get("flash"))
            lib_ms = row["library_ms"]
            row["over_library"] = None if lib_ms is None else row["ms"] / lib_ms
            log(f"  {case:12s} {row['kernel']:14s} {dtype_name:8s} err {row['max_abs_err']:.3e} "
                f"(least atol {row['least_atol']:.3e})  kernel {row['ms']:.4f} ms  plain "
                f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})  "
                f"{row['library']} {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")
        if bwd_ms:
            log(f"  {case:12s} sdpa backward alone (yardsticks): "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in bwd_ms.items()))
        rows += case_rows
        del qkv, q, k, v, do, o_ref, lse_ref, delta, qt, kt, vt, dot
        torch.cuda.empty_cache()
    return rows


def fold_phase(fa):
    """K4 against its plain twin at every fold case; returns per-case rows."""
    import torch

    rows = []
    for case, B, Lq, Lk, H, D, dtype_name, causal, q_shard, k_shard, tail, perm in FOLD_CASES:
        dtype = getattr(torch, dtype_name)
        tol = TOLERANCE[dtype_name]
        gen = torch.Generator(device="cuda").manual_seed(4321)
        # q and the rows' own k, v as views of one fused projection, as the model gives them
        qkv = (torch.randn(B, Lq, 3, H, D, generator=gen, device="cuda") * 0.5).to(dtype)
        q, k_own, v_own = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        kv = (torch.randn(B, Lk, 2, H, D, generator=gen, device="cuda") * 0.5).to(dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
        q_pos = q_shard * Lq + torch.arange(Lq, dtype=torch.int32, device="cuda")
        k_pos = k_shard * Lk + torch.arange(Lk, dtype=torch.int32, device="cuda")
        if perm:
            order = torch.randperm(Lk, generator=torch.Generator().manual_seed(5))
            k_pos = k_pos[order.to("cuda")]
        if tail:
            k_pos[-tail:] = -1
        m = torch.full((B, H, Lq), float("-inf"), device="cuda")
        l = torch.zeros((B, H, Lq), device="cuda")
        o = torch.zeros((B, Lq, H, D), device="cuda")
        if causal and k_shard != q_shard:  # the ring folds the diagonal first
            m, l, o = fa.flash_shard_update_plain(q, k_own, v_own, q_pos, q_pos, m, l, o, True)
        args = (q, k, v, q_pos, k_pos, m, l, o, causal)
        poison(m, l, o)
        before = dict(fa.LAUNCHES)
        got = fa.flash_shard_update_cuda(*args)
        torch.cuda.synchronize()
        moved = [n for n in fa.LAUNCHES if fa.LAUNCHES[n] != before[n]]
        if len(moved) != 1:
            raise AssertionError(f"{case}: launch counters moved {moved}")
        want = fa.flash_shard_update_plain(*args)
        scale = want[1].clamp_min(1.0).permute(0, 2, 1)[..., None]
        err, _ = worst(check_close(f"{case} m", got[0], want[0], tol["m"]),
                       check_close(f"{case} l", got[1], want[1], tol["l"]),
                       check_close(f"{case} o", got[2], want[2], tol["fold_o"], scale))
        o_err_over_l = float(((got[2] - want[2]).abs() / scale).max().item())
        live = (k_pos >= 0)[None, :] & ((q_pos[:, None] >= k_pos[None, :]) | (not causal))
        live_pairs = int(live.sum().item())
        b_ms, b_by = bound_fold(B, H, D, dtype_name, live)
        row = {"case": case, "kernel": moved[0], "shape": [B, Lq, Lk, H, D],
               "dtype": dtype_name, "causal": causal, "shards": [q_shard, k_shard],
               "live_pairs_per_bh": live_pairs, "max_abs_err": err,
               "o_err_over_l": o_err_over_l,
               "ms": time_ms(lambda: fa.flash_shard_update_cuda(*args), 30),
               # about 30 launches a call: 10 calls stay inside the card's launch queue
               "plain_ms": time_ms(lambda: fa.flash_shard_update_plain(*args), 10),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        rows.append(row)
        log(f"  {case:18s} {moved[0]:18s} {dtype_name:8s} live pairs {live_pairs:6d} err {err:.3e} "
            f"(o over max(l, 1) {o_err_over_l:.3e})  kernel "
            f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        del qkv, kv, got, want, args
        torch.cuda.empty_cache()
    return rows


def reference_phase(ft):
    """One FedAvg round of a small TransformerLM (head dim 32) on the card and
    on the CPU from the same seed: the shuffles come from CPU generators, so
    the runs differ only by the kernels against their plain versions and by
    sums taken in another order."""
    import copy

    import torch
    from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    finals = {}
    for dev_type in ("gpu", "cpu"):
        config = copy.deepcopy(SLICE_CONFIG)
        config["data_args"].update(partition_method="homo", synthetic_train_size=320)
        config["train_args"].update(client_num_in_total=8, client_num_per_round=4,
                                    comm_round=1, batch_size=16)
        config["device_args"]["device_type"] = dev_type
        args = ft.init(ft.Arguments.from_dict(config), should_init_logs=False)
        device = ft.device.get_device(args)
        dataset, _ = ft.data.load(args)
        model = TransformerLM(TransformerConfig(vocab_size=96, d_model=64, n_heads=2,
                                                n_layers=1, d_ff=128), device="meta")
        runner = ft.FedMLRunner(args, device, dataset, model)
        ev = runner.run()
        finals[dev_type] = ({k: v.float().cpu() for k, v in runner.runner.sim.variables.items()},
                            ev)
    worst = 0.0
    for name, g in finals["gpu"][0].items():
        c = finals["cpu"][0][name]
        err = (g - c).abs().max().item()
        if not torch.allclose(g, c, atol=1e-4, rtol=1e-4):
            raise AssertionError(f"reference: {name} differs card vs CPU by {err:.3e}")
        worst = max(worst, err)
    for key in ("test_acc", "test_loss"):
        if abs(finals["gpu"][1][key] - finals["cpu"][1][key]) > 2e-3:
            raise AssertionError(f"reference: {key} {finals['gpu'][1]} vs {finals['cpu'][1]}")
    log(f"  card vs CPU after one round: max |param diff| {worst:.3e} (atol 1e-4 + rtol 1e-4); "
        f"eval {finals['gpu'][1]} vs {finals['cpu'][1]}")
    return worst


def sp_reference_phase():
    """One SGD step of a small sequence-parallel TransformerLM (sp 4, 2 heads
    x 32) on the card (K4) and on the CPU (its plain twin) from the same
    weights and tokens, fp32 with TF32 off: the parameters must agree."""
    import types

    import torch
    from fedml_tpu_torch.ml.engine.train import make_optimizer
    from fedml_tpu_torch.models.transformer import TransformerConfig
    from fedml_tpu_torch.parallel import create_mesh
    from fedml_tpu_torch.parallel.seq_parallel import sp_init, sp_loss_fn

    cfg = TransformerConfig(vocab_size=96, d_model=64, n_heads=2, n_layers=2, d_ff=128)
    init = sp_init(cfg, seed=3, device=torch.device("cpu"))
    seq = torch.randint(0, cfg.vocab_size, (2, 65), generator=torch.Generator().manual_seed(4))
    finals, losses = {}, {}
    for dev in (torch.device("cuda", torch.cuda.current_device()), torch.device("cpu")):
        mesh = create_mesh((4,), ("sp",), dev)
        params = {n: p.to(dev).clone().requires_grad_() for n, p in init.items()}
        opt = make_optimizer(types.SimpleNamespace(client_optimizer="sgd", learning_rate=0.1))(
            list(params.values()))
        loss = sp_loss_fn(cfg, mesh)(params, seq[:, :-1].to(dev), seq[:, 1:].to(dev))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        finals[dev.type] = {n: p.detach().cpu() for n, p in params.items()}
        losses[dev.type] = float(loss.detach())
    worst = 0.0
    for name, g in finals["cuda"].items():
        c = finals["cpu"][name]
        if not torch.allclose(g, c, atol=1e-4, rtol=1e-4):
            raise AssertionError(f"sp reference: {name} differs card vs CPU by "
                                 f"{(g - c).abs().max().item():.3e}")
        worst = max(worst, (g - c).abs().max().item())
    log(f"  sp step card vs CPU: loss {losses['cuda']:.6f} vs {losses['cpu']:.6f}; "
        f"max |param diff| {worst:.3e} (atol 1e-4 + rtol 1e-4)")
    return {"max_param_diff": worst, "loss_card": losses["cuda"], "loss_cpu": losses["cpu"]}


def slice_phase(ft, fa):
    import copy

    fa.reset_launches()  # count only the main path's launches from here
    args = ft.init(ft.Arguments.from_dict(copy.deepcopy(SLICE_CONFIG)), should_init_logs=False)
    device = ft.device.get_device(args)
    t0 = time.perf_counter()
    dataset, output_dim = ft.data.load(args)
    model = ft.models.hub.create(args, output_dim)
    data_model_s = time.perf_counter() - t0
    runner = ft.FedMLRunner(args, device, dataset, model)
    final = runner.run()
    launches = dict(fa.LAUNCHES)
    log(f"  data + model in {data_model_s:.1f} s: train {dataset[0]} test {dataset[1]}"
        f" sequences, vocab {model.cfg.vocab_size}, d_model {model.cfg.d_model}, "
        f"{model.cfg.n_layers} layers, {model.cfg.n_heads} heads")
    sim = runner.runner.sim
    cfg = model.cfg
    n_eval_rounds = int(args.comm_round)  # frequency_of_the_test 1
    eval_batches = -(-dataset[1] // 256)
    eval_fwd = n_eval_rounds * eval_batches * cfg.n_layers
    log(f"  launches {launches}; eval forwards expected {eval_fwd}")
    for name in SLICE1_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    if any(launches[name] for name in launches if name not in SLICE1_KERNELS):
        raise AssertionError(f"a bf16 kernel or the ring's fold launched on slice 1's path: "
                             f"{launches}")
    if launches["flash_bwd_dq"] != launches["flash_bwd_dkv"]:
        raise AssertionError("dQ and dK/dV launch counts differ")
    if launches["flash_fwd"] - launches["flash_bwd_dq"] != eval_fwd:
        raise AssertionError("the forward kernel's launches do not cover training + eval")
    if not all(math.isfinite(x) for x in sim.round_losses) or len(sim.round_losses) != 3:
        raise AssertionError(f"train losses {sim.round_losses}")
    if not ("test_acc" in final and "test_loss" in final and math.isfinite(final["test_loss"])):
        raise AssertionError(f"eval {final}")
    tp = sim.throughput()
    log(f"  round times {[round(t, 3) for t in sim.round_times]} s; train losses "
        f"{[round(x, 4) for x in sim.round_losses]}; final eval {final}")
    log(f"  throughput {json.dumps(tp)}")
    return launches, final, tp, list(sim.round_times), list(sim.round_losses)


def profile_phase(ft, fa):
    """Where one client's local training spends its time: torch.profiler over
    one full-width client run (the main path's counts were read before)."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile

    args = ft.init(ft.Arguments.from_dict(copy.deepcopy(SLICE_CONFIG)), should_init_logs=False)
    device = ft.device.get_device(args)
    dataset, output_dim = ft.data.load(args)
    runner = ft.FedMLRunner(args, device, dataset, ft.models.hub.create(args, output_dim))
    sim = runner.runner.sim
    cid = int(np.argmax(sim.client_counts))
    rows = sim.client_idx[cid]
    x, y = sim.x_all.index_select(0, rows), sim.y_all.index_select(0, rows)
    n = int(sim.client_counts[cid])
    sim._local_train(sim.variables, x, y, n, seed=(0, 0, cid))  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        sim._local_train(sim.variables, x, y, n, seed=(0, 0, cid))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an operator's device time repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    steps = sim.padded_n // sim.batch_size
    log(f"  one client ({n} rows, {steps} steps): wall {wall_ms:.1f} ms under the profiler, "
        f"device busy {device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f} %)")
    table = []
    for e in top:
        table.append({"name": e.key, "device_ms": e.self_device_time_total / 1e3,
                      "calls": e.count})
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "steps": steps, "top": table}


def sp_slice_phase(fa):
    """Slice 2 at full width: fp32 parity of sp logits with single-card
    logits, then one warm and 3 timed bf16 SGD steps; the counts are set to
    0 just before the sp forward and read after the last step.  One more step
    runs under torch.profiler after that."""
    import dataclasses
    import types

    import torch
    from torch.func import functional_call
    from torch.profiler import ProfilerActivity, profile
    from fedml_tpu_torch.ml.engine.train import make_optimizer
    from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from fedml_tpu_torch.parallel import create_mesh
    from fedml_tpu_torch.parallel.seq_parallel import sp_apply, sp_init, sp_loss_fn

    cfg = TransformerConfig(max_seq_len=SP_LEN, **SP_CONFIG)  # fp32 compute
    mesh = create_mesh((SP_SHARDS,), ("sp",))  # the card
    t0 = time.perf_counter()
    params = sp_init(cfg, seed=0)
    n_params = sum(p.numel() for p in params.values())
    seq = torch.randint(0, cfg.vocab_size, (SP_BATCH, SP_LEN + 1),
                        generator=torch.Generator().manual_seed(7)).to(mesh.device)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    torch.cuda.synchronize()
    log(f"  {n_params / 1e6:.1f} M parameters on {mesh.device} in {time.perf_counter() - t0:.1f} s"
        f"; tokens {tuple(tokens.shape)}, mesh {mesh.shape}")
    with torch.no_grad():
        single = functional_call(TransformerLM(cfg, device="meta"), params, (tokens,))
        torch.cuda.synchronize()
        fa.reset_launches()  # slice 2's main path from here
        logits = sp_apply(cfg, params, tokens, mesh)
        torch.cuda.synchronize()
    fwd_launches = dict(fa.LAUNCHES)
    if tuple(logits.shape) != (SP_BATCH, SP_LEN, cfg.vocab_size):
        raise AssertionError(f"sp logits shape {tuple(logits.shape)}")
    parity, _ = check_close("sp logits vs single-card", logits, single, (SP_PARITY_ATOL, 0.0))
    log(f"  fp32 sp logits (ring, K4) vs single-card logits (K1): max |diff| {parity:.3e} "
        f"(atol {SP_PARITY_ATOL}); |logits| max {single.abs().max().item():.3f}")
    del single, logits
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    for p in params.values():
        p.requires_grad_()
    opt = make_optimizer(types.SimpleNamespace(client_optimizer="sgd", learning_rate=SP_LR))(
        list(params.values()))
    loss_fn = sp_loss_fn(dataclasses.replace(cfg, dtype=torch.bfloat16), mesh)

    def step():
        loss = loss_fn(params, tokens, targets)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return float(loss.detach())  # waits for the step

    losses, step_s = [], []
    for _ in range(4):  # one warm step, then 3 timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    per_forward = cfg.n_layers * SP_SHARDS ** 2
    log(f"  launches after the fp32 forward {fwd_launches}; after 4 bf16 steps {launches}; "
        f"{per_forward} K4 folds per forward expected")
    step_launches = {n: launches[n] - fwd_launches[n] for n in launches}
    # the fp32 forward runs the fp32 K4, the 4 bf16 steps the bf16 one, nothing else
    for counts, kernel, forwards in ((fwd_launches, "flash_shard_update", 1),
                                     (step_launches, "flash_update_sm90", 4)):
        want = dict.fromkeys(counts, 0)
        want[kernel] = forwards * per_forward
        if counts != want:
            raise AssertionError(f"{forwards} forwards must launch {want}, got {counts}")
    if not all(math.isfinite(x) for x in losses) or abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"bf16 losses {losses} (ln V = {math.log(cfg.vocab_size):.3f})")
    timed = statistics.median(step_s[1:])
    tokens_per_s = SP_BATCH * SP_LEN / timed
    log(f"  bf16 SGD steps: losses {[round(x, 4) for x in losses]}; step seconds "
        f"{[round(t, 4) for t in step_s]}; median of the 3 timed {timed:.4f} s, "
        f"{tokens_per_s:,.0f} tokens/s; peak memory {peak / 2**30:.2f} GiB")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    fold = [e for e in events if "flash_update_sm90_kernel" in e.key]
    fold_ms = sum(e.self_device_time_total for e in fold) / 1e3
    log(f"  one bf16 step under the profiler: wall {wall_ms:.1f} ms, device busy {device_ms:.1f} "
        f"ms ({100 * device_ms / wall_ms:.1f} %); K4 {fold_ms:.3f} ms in "
        f"{sum(e.count for e in fold)} launches")
    table = []
    for e in top:
        table.append({"name": e.key, "device_ms": e.self_device_time_total / 1e3,
                      "calls": e.count})
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    return launches, {"params": n_params, "parity_max_abs_diff": parity,
                      "forward_launches": fwd_launches, "launches": launches, "losses": losses,
                      "step_seconds": step_s, "median_step_s": timed,
                      "tokens_per_s": tokens_per_s, "peak_memory_bytes": peak,
                      "profile": {"wall_ms": wall_ms, "device_ms": device_ms, "fold_ms": fold_ms,
                                  "top": table}}


def ptxas_check(build, builds) -> dict:
    """Registers and spills of every kernel instantiation from ptxas's log;
    raises if an instantiation of a kernel of NO_SPILL spills."""
    usage = {}
    for src, b in builds.items():
        for name, u in build.ptxas_usage(b["log"]).items():
            usage[build.kernel_label(name)] = dict(u, source=src)
    if not usage:
        raise AssertionError("no ptxas usage lines in the build logs")
    for label in sorted(usage):
        u = usage[label]
        log(f"  ptxas {label:42s} {u.get('registers')} registers, {u.get('stack')} B stack, "
            f"{u.get('spill_stores')} B spill stores, {u.get('spill_loads')} B spill loads")
    spills = {label: u for label, u in usage.items()
              if label.split("<")[0] in NO_SPILL and (u.get("spill_stores") or u.get("spill_loads"))}
    if spills:
        raise AssertionError(f"kernel instantiations spill: {spills}")
    return usage


def bench_bf16_summary(rows) -> dict:
    """The bench_bf16 rows of K1-K3 with their yardsticks."""
    keys = ("ms", "bound_ms", "bound_by", "plain_ms", "max_abs_err", "least_atol", "library",
            "library_ms")
    return {r["kernel"]: dict({k: r[k] for k in keys}, over_library=r["ms"] / r["library_ms"],
                              sdpa_flash_bwd_ms=r.get("sdpa_flash_bwd_ms"))
            for r in rows
            if r["case"] == "bench_bf16"
            and r["kernel"] in ("flash_fwd_sm90", "flash_dq_sm90", "flash_dkv_sm90")}


def kernels_line(rows, path_launches) -> list:
    """The kernels line's entries: each kernel's phase-2 row of record and its
    launches on the main paths (each path's counts were set to 0 just before
    it ran and read just after; a kernel's launches are their sum)."""
    kernels = []
    for name, source, replaces, case in KERNELS:
        r = next(r for r in rows if r["case"] == case and r["kernel"] == name)
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": sum(counts[name] for counts in path_launches),
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"], "library": r.get("library")}
        if r.get("sdpa_flash_bwd_ms") is not None:
            entry["sdpa_flash_bwd_ms"] = r["sdpa_flash_bwd_ms"]
        kernels.append(entry)
    return kernels


def single_card_phase(ft, fa):
    """bench.py's TransformerLM leg on one card: the bench-width TransformerLM
    (flash attention: the bf16 tensor-core K1 and K3, and K2) in bf16 compute
    over fp32 params, B 8 x L 1024, SGD lr 1e-3, through the engine's loss and
    optimizer.  The counts are set to 0 just before the warm step and read
    after each step; one more step runs under torch.profiler after that."""
    import types

    import torch
    from torch.profiler import ProfilerActivity, profile
    from fedml_tpu_torch.ml.engine.train import build_loss_fn, init_variables, make_optimizer
    from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    cfg = TransformerConfig(max_seq_len=SP_LEN, dtype=torch.bfloat16, **SP_CONFIG)
    device = ft.device.get_device()  # the card
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="meta")
    n_params = sum(p.numel() for p in init_variables(model, device, seed=0).values())
    seq = torch.randint(0, cfg.vocab_size, (SP_BATCH, SP_LEN + 1),
                        generator=torch.Generator().manual_seed(7)).to(device)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    mask = torch.ones(SP_BATCH, SP_LEN, device=device)
    loss_fn = build_loss_fn(model)
    opt = make_optimizer(types.SimpleNamespace(client_optimizer="sgd", learning_rate=SP_LR))(
        list(model.parameters()))
    torch.cuda.synchronize()
    log(f"  {n_params / 1e6:.1f} M parameters on {device} in {time.perf_counter() - t0:.1f} s; "
        f"tokens {tuple(tokens.shape)}, compute {cfg.dtype}")

    def step():
        loss = loss_fn(tokens, targets, mask)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return float(loss.detach())  # waits for the step

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()  # this path's launches from here
    losses, step_s, per_step = [], [], []
    for _ in range(4):  # one warm step, then 3 timed
        before = dict(fa.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t0)
        per_step.append({n: fa.LAUNCHES[n] - before[n] for n in before})
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(fa.LAUNCHES, 0)
    want.update(flash_fwd_sm90=cfg.n_layers, flash_dq_sm90=cfg.n_layers,
                flash_dkv_sm90=cfg.n_layers)
    log(f"  launches per step {per_step}; after 4 steps {launches}")
    if any(counts != want for counts in per_step):
        raise AssertionError(f"each step must launch {want}, got {per_step}")
    if not all(math.isfinite(x) for x in losses) or abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"bf16 losses {losses} (ln V = {math.log(cfg.vocab_size):.3f})")
    timed = statistics.median(step_s[1:])
    tokens_per_s = SP_BATCH * SP_LEN / timed
    log(f"  bf16 SGD steps: losses {[round(x, 4) for x in losses]}; step seconds "
        f"{[round(t, 4) for t in step_s]}; median of the 3 timed {timed:.4f} s, "
        f"{tokens_per_s:,.0f} tokens/s; peak memory {peak / 2**30:.2f} GiB")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"  one bf16 step under the profiler: wall {wall_ms:.1f} ms, device busy {device_ms:.1f} "
        f"ms ({100 * device_ms / wall_ms:.1f} %)")
    table = []
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:16]:
        table.append({"name": e.key, "device_ms": e.self_device_time_total / 1e3,
                      "calls": e.count})
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    flash_ms = {name: sum(e.self_device_time_total for e in events if name in e.key) / 1e3
                for name in ("flash_fwd_sm90_kernel", "flash_dq_sm90_kernel",
                             "flash_dkv_sm90_kernel")}
    log(f"  attention kernels in the profiled step: {json.dumps(flash_ms)}")
    return launches, {"params": n_params, "per_step_launches": per_step, "launches": launches,
                      "losses": losses, "step_seconds": step_s, "median_step_s": timed,
                      "tokens_per_s": tokens_per_s, "peak_memory_bytes": peak,
                      "profile": {"wall_ms": wall_ms, "device_ms": device_ms,
                                  "attention_ms": flash_ms, "top": table}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import fedml_tpu_torch as ft
    from fedml_tpu_torch.ops import build, flash_attention as fa
    from fedml_tpu_torch.simulation.xla.fed_sim import pin_fp32_matmul

    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    log("== phase 1: device and build")
    card = card_line()
    log(f"  card: {card}")
    log(f"  python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"  tf32 flags: {pin_fp32_matmul()}")
    t0 = time.perf_counter()
    builds = build.build()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{s} {b['seconds']:.1f} s" for s, b in builds.items()))
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
        for src, b in builds.items():
            f.write(f"== {src}\n{b['log']}\n")
    ptxas = ptxas_check(build, builds)

    log("== phase 2: kernels against their plain versions")
    rows = kernel_phase(fa)
    fold_rows = fold_phase(fa)

    log("== phase 3: reference (card vs CPU: one FedAvg round; one sp SGD step)")
    ref_err = reference_phase(ft)
    sp_ref = sp_reference_phase()

    log("== phase 4: slice 1 (FedAvg, hub transformer, shakespeare, 3 rounds)")
    launches, final, tp, round_times, losses = slice_phase(ft, fa)

    log("== phase 5: profile of one client's local training")
    prof = profile_phase(ft, fa)

    log("== phase 6: slice 2 (sequence-parallel TransformerLM, bench width, sp 4)")
    sp_launches, sp_slice = sp_slice_phase(fa)

    log("== phase 7: single card (bench.py's TransformerLM leg, bf16, B 8 x L 1024)")
    single_launches, single = single_card_phase(ft, fa)

    kernels = kernels_line(rows + fold_rows, (launches, sp_launches, single_launches))
    bench = bench_bf16_summary(rows)
    with open(os.path.join(OUT_DIR, "results.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "ptxas": ptxas, "cases": rows, "folds": fold_rows, "bench_bf16": bench,
                   "reference_max_param_diff": ref_err,
                   "sp_reference": sp_ref, "launches": launches,
                   "final_eval": final, "throughput": tp, "round_times": round_times,
                   "round_losses": losses, "kernels": kernels, "profile": prof,
                   "sp_slice": sp_slice, "single_card": single,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"bench_bf16": bench}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
