#!/usr/bin/env python3
"""Drive the PyTorch port (fedml_tpu_torch) on one CUDA card, in phases.

    python3 chip_smoke.py

1. Device and build: the card's name and power limit, torch/CUDA versions,
   the TF32 flags; then the CUDA kernels are built with nvcc from
   fedml_tpu_torch/ops/csrc (one nvcc per source, in parallel).
2. Kernels: each flash-attention kernel (forward, dQ, dK/dV) against its
   plain PyTorch version on the same inputs, at the slice's shapes (B 32 and,
   for the eval forward, B 256; L 80, H 8, D 32, fp32, causal), a ragged
   non-causal case (L 50) and the TransformerLM bench shape (B 8, L 1024,
   H 16, D 64) in bf16 and fp32, with the tolerances below.  Kernel, plain
   version and F.scaled_dot_product_attention (a yardstick only; the port
   never calls it) are timed on the device with CUDA events around a queue
   of calls, median of trials (``time_ms``).
3. Reference: one FedAvg round of a small TransformerLM on the card
   (kernels) and on the CPU (plain versions) from the same seed must agree.
4. Slice: FedAvg of the full-width hub TransformerLM on shakespeare
   (100 clients, 10 per round, 3 rounds) through fedml_tpu_torch.init ->
   data.load -> models.hub.create -> FedMLRunner(...).run(), with every
   kernel's launch count read just after the run.
5. Profile: torch.profiler over one client's local training, after the
   main path's counts were read: device-busy share and the top kernels.
6. The kernels line, the card line, and the last line
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
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 outside tensor cores; bf16 dense
# tolerance per dtype: |kernel - plain| <= atol + rtol * |plain|, elementwise.
# fp32: the two sum in another order (fp32 FMA on both sides, no TF32).
# bf16: outputs are rounded to bf16 (2^-8 relative), and the kernel rounds P
# against its running max where the plain version uses the row max, so one
# bf16 step either way on the larger entries.
TOLERANCE = {
    "float32": {"o": (2e-5, 1e-5), "lse": (1e-5, 1e-6), "grad": (1e-4, 1e-4)},
    "bfloat16": {"o": (1e-2, 2e-2), "lse": (1e-4, 1e-5), "grad": (2e-2, 3e-2)},
}
KERNEL_SOURCES = {
    "flash_fwd": ("fedml_tpu_torch/ops/csrc/flash_fwd.cu",
                  "fedml_tpu/ops/flash_attention.py:56 _flash_kernel"),
    "flash_bwd_dq": ("fedml_tpu_torch/ops/csrc/flash_bwd.cu",
                     "fedml_tpu/ops/flash_attention.py:211 _flash_bwd_dq_kernel"),
    "flash_bwd_dkv": ("fedml_tpu_torch/ops/csrc/flash_bwd.cu",
                      "fedml_tpu/ops/flash_attention.py:245 _flash_bwd_dkv_kernel"),
}
# (name, B, L, H, D, dtype, causal, kernels to check)
CASES = [
    ("slice_train", 32, 80, 8, 32, "float32", True, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    ("slice_eval", 256, 80, 8, 32, "float32", True, ("flash_fwd",)),
    ("ragged_full", 4, 50, 8, 32, "float32", False, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    ("bench_bf16", 8, 1024, 16, 64, "bfloat16", True, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    ("bench_fp32", 8, 1024, 16, 64, "float32", True, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
]
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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def poison(*like) -> None:
    """Fill blocks the size of the coming outputs with NaN and free them, so
    the allocator hands NaN memory to the kernel's outputs: an output the
    kernel never writes then fails the finiteness check."""
    import torch

    blocks = [torch.full_like(t, float("nan")) for t in like]
    del blocks


def check_close(name: str, got, want, tol) -> float:
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if not bool(got.float().isfinite().all()):
        raise AssertionError(f"{name}: non-finite values")
    if bool((err > limit).any()):
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} exceeds "
                             f"atol {atol} + rtol {rtol}")
    return float(err.max().item())


def kernel_phase(fa):
    """Compare and time every kernel at every case; returns per-case rows."""
    import torch
    import torch.nn.functional as F

    rows = []
    for case, B, L, H, D, dtype_name, causal, kernels in CASES:
        dtype = getattr(torch, dtype_name)
        tol = TOLERANCE[dtype_name]
        gen = torch.Generator(device="cuda").manual_seed(1234)
        # q, k, v as views of one fused [B, L, 3, H, D] projection, as the model gives them
        qkv = (torch.randn(B, L, 3, H, D, generator=gen, device="cuda") * 0.5).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = (torch.randn(B, L, H, D, generator=gen, device="cuda") * 0.5).to(dtype)
        o_ref, lse_ref = fa.flash_forward_plain(q, k, v, causal)
        delta = (do.float() * o_ref.float()).sum(-1).permute(0, 2, 1).contiguous()
        for name in kernels:
            poison(do, do, lse_ref)
            if name == "flash_fwd":
                o, lse = fa.flash_forward_cuda(q, k, v, causal)
                torch.cuda.synchronize()
                err = max(check_close(f"{case} O", o, o_ref, tol["o"]),
                          check_close(f"{case} LSE", lse, lse_ref, tol["lse"]))
                run_k = lambda: fa.flash_forward_cuda(q, k, v, causal)
                run_p = lambda: fa.flash_forward_plain(q, k, v, causal)
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                run_l = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            elif name == "flash_bwd_dq":
                dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse_ref, delta, causal)
                torch.cuda.synchronize()
                dq_ref = fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)
                err = check_close(f"{case} dQ", dq, dq_ref, tol["grad"])
                run_k = lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse_ref, delta, causal)
                run_p = lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)
                run_l = None
            else:
                dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta, causal)
                torch.cuda.synchronize()
                dk_ref, dv_ref = fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)
                err = max(check_close(f"{case} dK", dk, dk_ref, tol["grad"]),
                          check_close(f"{case} dV", dv, dv_ref, tol["grad"]))
                run_k = lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta, causal)
                run_p = lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)
                run_l = None
            reps = 10 if L >= 1024 else 30
            b_ms, b_by = bound(name, B, L, H, D, dtype_name, causal)
            row = {"case": case, "kernel": name, "shape": [B, L, H, D], "dtype": dtype_name,
                   "causal": causal, "max_abs_err": err, "ms": time_ms(run_k, reps),
                   "plain_ms": time_ms(run_p, reps), "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": time_ms(run_l, reps) if run_l is not None else None}
            rows.append(row)
            log(f"  {case:12s} {name:14s} {dtype_name:8s} err {err:.3e}  kernel {row['ms']:.4f} ms"
                f"  plain {row['plain_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})"
                f"  sdpa {row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)}")
        if "flash_bwd_dq" in kernels:
            # yardstick for the two backward kernels together: SDPA fwd+bwd
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
                torch.autograd.grad(out, (qt, kt, vt), dot)

            ms = time_ms(sdpa_fwd_bwd, 10 if L >= 1024 else 30)
            rows.append({"case": case, "kernel": "sdpa_fwd_bwd", "library_ms": ms})
            log(f"  {case:12s} sdpa fwd+bwd (yardstick) {ms:.4f} ms")
        del qkv, q, k, v, do, o_ref, lse_ref, delta
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
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
    for src, b in builds.items():
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    log("== phase 2: kernels against their plain versions")
    rows = kernel_phase(fa)

    log("== phase 3: reference (one round, card vs CPU)")
    ref_err = reference_phase(ft)

    log("== phase 4: slice (FedAvg, hub transformer, shakespeare, 3 rounds)")
    launches, final, tp, round_times, losses = slice_phase(ft, fa)

    log("== phase 5: profile of one client's local training")
    prof = profile_phase(ft, fa)

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        r = next(r for r in rows if r["case"] == "slice_train" and r["kernel"] == name)
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    with open(os.path.join(OUT_DIR, "results.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "cases": rows, "reference_max_param_diff": ref_err, "launches": launches,
                   "final_eval": final, "throughput": tp, "round_times": round_times,
                   "round_losses": losses, "kernels": kernels, "profile": prof,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
