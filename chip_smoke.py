#!/usr/bin/env python3
"""Drive the PyTorch port (fedml_tpu_torch) on one CUDA card, in phases.

    python3 chip_smoke.py

1. Device and build: the card's name and power limit, torch/CUDA versions,
   the TF32 flags; then the CUDA kernels are built with nvcc from
   fedml_tpu_torch/ops/csrc (one nvcc per source, in parallel), and ptxas's
   registers and spills of every kernel instantiation are logged: a spill in
   a kernel of NO_SPILL fails the phase.
2. Kernels: each flash-attention kernel (forward, dQ, dK/dV; in bf16 the
   tensor-core kernels; in fp32 the split-TF32 tensor-core kernels) against
   its plain PyTorch version on the same inputs, at the slice's shapes (B 32 and, for the eval forward, B 256;
   L 80, H 8, D 32, fp32, causal), a ragged non-causal case (L 50) and the
   TransformerLM bench shape (B 8, L 1024, H 16, D 64) in bf16 and fp32,
   with the tolerances below.  Then ring
   attention's shard fold (K4) against its plain twin at the sequence-
   parallel slice's fold (B 8, Lq = Lk 256, H 16, D 64): the three kinds of
   fold a causal ring makes (keys before the rows, the diagonal, keys after
   the rows) in bf16 and fp32, ragged non-causal folds with padded keys in
   fp32 and (D 32) bf16, and in both types a diagonal fold whose key
   positions are a seeded permutation.
   Kernel, plain version and, where one PyTorch call computes the same
   function, that call (F.scaled_dot_product_attention, its efficient-
   attention backward and, in bf16, its flash-attention backward: yardsticks
   only, the port never calls them) are timed on the device with CUDA events
   around a queue of calls, median of trials (``time_ms``).  The bench_bf16
   rows of K1-K3 and their yardsticks are printed on a line of their own.
3. Reference: one FedAvg round of a small TransformerLM on the card
   (kernels) and on the CPU (plain versions) from the same seed must agree;
   so must one SGD step of a small sequence-parallel TransformerLM (sp 4),
   and one packed FedAvg round of a ResNet-20 in fp32 with TF32 off (8
   clients of 2 batches each, the same weights on both); then 2 packed
   rounds of SCAFFOLD and of FedNova on that ResNet-20, whose params,
   server state and client-state table must agree with the CPU's.
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
   model's (flash attention, K1), that fp32 forward under torch.profiler for
   the fp32 K4's device time, then one warm and 3 timed bf16 SGD steps,
   with the launch counts read just after: the fp32 forward launches the fp32
   K4 128 times, each bf16 forward the bf16 K4 128 times, and nothing else.
7. Single card: bench.py's TransformerLM leg (_measure_transformer,
   bench.py:1465-1502) on one card: the same width and B 8 x L 1024, bf16
   compute over fp32 params, SGD lr 1e-3, the TransformerLM with its default
   flash attention, through the engine's loss (build_loss_fn) and
   make_optimizer: one warm and 3 timed steps, each launching exactly 8 K1,
   8 K2 and 8 K3 (the bf16 tensor-core kernels) and no K4, then one step
   under torch.profiler.
8. Slice 3: bench.py's north-star configuration (_bench_args(1),
   bench.py:97-128) through fedml_tpu_torch.init -> data.load ->
   models.hub.create -> FedMLRunner(...).run(): FedAvg of ResNet-56
   (GroupNorm, bf16 compute over fp32 params) on cifar10 (synthetic, 50,000
   NHWC images stored in bf16), 100 Dirichlet(0.5) clients, 32 a round
   through the packed round, batch 64, SGD lr 0.001.  Cut: 2 rounds instead
   of 6 (3 before phase 16 was added).  It checks the bf16 storage bit for bit, logs each round's seconds,
   real steps and bucket, throughput() and the peak memory, requires finite
   losses, and asserts that no flash kernel launched.  Then 8 clients of
   round 1's cohort run once more under torch.profiler: busy share, the top kernels, the
   device time of convolutions, GroupNorm and elementwise kernels, and the
   aten ops a step.  A lone F.group_norm on channels_last input shows
   whether it copies to contiguous; the boundary flush is timed on its own
   with CUDA events.
9. The kernels line, the card line, and the last line
   {"ok": true, "device": {...}}, printed after phase 18.
10. The algorithm zoo.  (a) At the north-star width: BENCH_CONFIG with the
   algorithm's knobs changed and its cohort cut to ZOO_COHORT (4) clients
   (ZOO: FedProx, FedOpt/adam, FedNova, SCAFFOLD, FedDyn, AsyncFedAvg,
   FedBuff with a buffer of 4), 2 rounds each, through the entry points,
   on one cifar10 dataset made once: round seconds, throughput(), losses,
   finite params, the server state's norm,
   SCAFFOLD's and FedDyn's mean invariant (c = mean_i c_i, h = mean_i h_i),
   FedBuff's flushes.  Then FedAvg's round and SCAFFOLD's alternated on one
   fixed cohort (FedAvg, SCAFFOLD, FedAvg, after a warm FedAvg round), and
   the aten ops a step of FedAvg, FedProx, SCAFFOLD and FedDyn under
   torch.profiler over a 2-client stream.  No flash kernel launches on this
   path.  (b) The grad hooks under the flash kernels: SCAFFOLD and FedDyn,
   2 rounds each, on slice 1's configuration (hub transformer, fp32), with
   the counts set to 0 before and read after: K1-K3 must have launched.
11. The trust path.  (a) At the north-star width (BENCH_CONFIG,
   byzantine_client_num 10, on phase 8's dataset), 7 runs of 1 round
   through the entry points (TRUST: byzantine random + krum, label flipping
   + trimmed mean, model replacement + norm clipping, FedNova + backdoor +
   foolsgold, padded SCAFFOLD + bulyan with f 7, LDP Gaussian with a budget
   spent exactly, central DP Laplace): round seconds, the security tail's
   ms a round (CUDA events), peak memory over a FedAvg round's, finite
   losses and params, the malicious set and the poisoned clients against
   get_byzantine_idxs, foolsgold's history, the accountant's spends; then
   FedAvg's round and byzantine + krum's alternated on one cohort.  (b) One
   captured round's [32, 855,770] fp32 stack through every stacked defense
   and attack on the card and on the CPU with the same draws, within
   TRUST_TOL (selections and foolsgold's weights within their own bounds,
   below), each card call timed.  (c) Krum + local DP on slice 1's
   configuration, TRUST_HOOKS_ROUNDS (2) rounds, counts set to 0 before and read after: K1-K3
   must have launched.
12. The sp backend (simulation/sp/fedavg/fedavg_api.py: clients one after
   another through the trainer, then the ServerAggregator hooks), run after
   phase 11 with the TF32 flags as the script found them (phases 1-11 run
   under the scoped fp32 pin; every sp run must leave the flags as it found
   them).  (a) A bare fedml_tpu_torch.run_simulation() with sys.argv stubbed
   and no --cf: the port's default config (simulation_sp: mnist lr, 1,000
   clients, 10 a round), its 200 rounds cut to 5 by the stub, on the card and
   on the CPU; then the four examples/simulation/sp_fedavg_* configs on the
   card (the robust one also with a zero attack in place of the random one).
   Deterministic runs (no DP, no random attack) must agree with the CPU's
   final params within SP_BACKEND_CPU_ATOL.  (b) BENCH_CONFIG on sp (no
   packing, a cohort of 8, an eval after each of 2 rounds) on phase 8's
   dataset, round 0 under torch.profiler for the card's busy share: round seconds and
   samples/s beside phase 8's packed round, each client's bucket and real
   steps, peak memory, no flash launch; then round 1's cohort in turns with
   the packed round on it (packed, sp, packed).  (c) Slice 1's
   configuration on sp, 2 rounds with an eval each, counts set to 0 before
   and read after: K2 and K3 launch layers x steps times (the trainer's
   recorded steps), K1 that plus layers x eval batches x evals.
13. The rest of the sp zoo (simulation/sp/*: FedProx, FedOpt, FedNova,
   FedSGD, SCAFFOLD, FedDyn, AsyncFedAvg, FedBuff, HierarchicalFL,
   decentralized, Turbo-Aggregate), with the TF32 flags as the script found
   them, as phase 12.  (a) The zoo's nine examples/simulation/sp_*_mnist_lr
   configs, and FedBuff (fl_mode async) and AsyncFedAvg on
   sp_fedavg_mnist_lr, on the card and on the CPU: every run is
   deterministic (Turbo-Aggregate's masks come from a CPU generator), so the
   final params must agree within SP_BACKEND_CPU_ATOL; then FedBuff under
   full participation, a buffer of the cohort, staleness 0 and the constant
   policy against FedAvgAPI on the card, bit for bit (or within 1e-6, the
   reason logged).  (b) Each member and FedAvg on BENCH_CONFIG on sp (no
   packing) with a cohort of 4 for 2 rounds (AsyncFedAvg: 8 updates;
   FedBuff: 4 flushes of 2) on phase 8's dataset, decentralized on 8 nodes
   with the data partitioned again at that count and cut to 4,000 images:
   round seconds, finite params, the member's invariant (SCAFFOLD's c =
   (1/N) sum_i c_i, FedDyn's h, FedNova's taus equal to the trainer's steps,
   FedBuff's flushes, HierarchicalFL's group sizes, decentralized's
   consensus equal to the mean of the nodes), peak memory over FedAvg's run,
   no flash launch.  (c) SCAFFOLD and FedSGD on slice 1's configuration on
   sp, 2 rounds each, counts set to 0 before each and read after: SCAFFOLD
   as 12c; FedSGD's gradients are one forward and backward over each
   client's padded data, so K2 = K3 = layers x client gradients and K1 that
   plus layers x eval batches x evals.
14. The FedNLP task family, with the TF32 flags as the script found them.
   (a) examples/simulation/sp_fedavg_s2s_transformer as it stands (FedAvg of
   the hub transformer_s2s, d_model 128, 4 heads x 32, 2 layers, on
   synthetic_s2s, L 24; 4 clients, 2 rounds, adam) through the entry points,
   then synthetic_s2s, agnews transformer_cls, onto_tagging
   transformer_tagger, squad_span transformer_span and stackoverflow_lr lr
   with the example's knobs but SGD, each again on the CPU: final metrics,
   seconds, final params within 2 lr (adam, the example) or NLP_CPU_ATOL
   (SGD); each seq2seq run's counts, set to 0 just before it and read just
   after, must be K2 = K3 = layers x the trainer's steps and K1 that plus
   layers x its evals (one forward over the test split each); the encoders
   and lr launch none.  (b) The example on the padded and the
   packed round, 3 rounds with an eval each: round seconds, samples/s, peak
   memory, launches against the steps, and one round under torch.profiler
   for the busy share.  (c) Phase 2's s2s rows (B 16 and the eval's B 102,
   L 24, H 4, D 32, fp32, causal) printed beside 14a's launches.
15. The FedGraphNN family (the GCN heads at the hub's width: hidden 64, 2
   layers, 16 nodes, 8 features, inputs [B, N, F+N]), with the TF32 flags as
   the script found them.  No flash kernel lies on these paths, as no Pallas
   kernel lies on them in the JAX package: every run's counts, set to 0 just
   before it and read just after, must stay 0.  (a) The example configs as
   they stand (sp_fedavg_linkpred_gcn, sp_spreadgnn_moleculenet_gcn and
   app/fedgraphnn/fedml_config.yaml, adam) through the entry points, then
   synthetic_graph gcn, ego_linkpred and recsys_linkpred gcn_linkpred,
   ego_nodeclf gcn_nodeclf, freesolv gcn_reg and moleculenet_mtl gcn_mtl
   under SpreadGNN with the linkpred example's knobs but SGD, each again on
   the CPU: final params (every node's for SpreadGNN) within 2 lr (adam) or
   GRAPH_CPU_ATOL (SGD).  (b) ego_linkpred and freesolv on the padded and the
   packed round, 3 rounds, SGD: round seconds, samples/s, the labels kept
   fp32, card against CPU within GRAPH_CPU_ATOL, and one round under
   torch.profiler for the busy share and the aten ops a step.  (c)
   decentralized FL (lr on mnist) and SpreadGNN (moleculenet_mtl) on backend
   XLA, the in-mesh gossip round, against their sp twins on the card in turns
   (XLA, sp, XLA, sp): every node's model within GRAPH_INMESH_ATOL.
16. The vision model zoo with segmentation and detection, with the TF32
   flags as the script found them.  No flash kernel lies on these paths (the
   JAX package runs these convolutions outside any Pallas kernel): the
   counts, set to 0 when the phase starts, must read 0 when it ends.  (a)
   examples/simulation/sp_fedseg_synthetic_unet (FedSegAPI: its own loop,
   SGD with momentum 0.9) and xla_fedseg_synthetic_unet (the round
   simulator's FedAvg round) as they stand: the hub UNet on synthetic_seg,
   pixel accuracy and mIoU.  (b) synthetic_det with tiny_detector on sp
   (FedAvg) and on the packed round (the det loss, [B, 5] float labels):
   class accuracy and box IoU.  Each run through the entry points and again
   on the CPU, final params within VISION_CPU_ATOL; the round simulator's
   runs log throughput() and one round under torch.profiler.  (c) One
   forward and one SGD step of each new hub model at its width (cnn,
   cnn_web, vgg11, vgg16, mobilenet, mobilenet_v3, efficientnet, unet,
   tiny_detector, mlp and the rnn family; [8, 32, 32, 3] images, [8, 28, 28,
   1] for the cnn keys, [8, 80] tokens, [8, 64] for mlp) in fp32 inside
   device.fp32_matmul(), on the card and on the CPU from one seed: logits and
   stepped params within VISION_STEP_RTOL, each card forward and step timed.
17. The structural sp members with their models and the in-mesh FedGAN and
   FedNAS rounds, with the TF32 flags as the script found them.  No flash
   kernel lies on these paths (the JAX package runs them outside any Pallas
   kernel): the counts, set to 0 when the phase starts, must read 0 when it
   ends.  (a) The example configs as they stand: sp_fedgan_mnist_gan
   (FedGanAPI: the GAN pair at gan_latent_dim 64, adam), sp_fednas_cifar10_darts
   (FedNASAPI: DARTS at width 16), sp_fedgkt_cifar10 (FedGKTAPI: the edge net
   at width 32, the server tower at width 64 with 3 blocks),
   xla_fedgan_mnist_gan and xla_fednas_cifar10_darts (the in-mesh rounds).
   (b) Split NN on mnist with xla_split_nn_mnist_mlp's knobs and vertical FL
   on synthetic with xla_vfl_synthetic_lr's, each on backend sp.  Each run
   through the entry points and again on the CPU: finite losses and final
   state, the final eval beside the CPU's, the run's seconds; the SGD-driven
   trees within STRUCTURAL_CPU_ATOL of the CPU's, the adam-driven ones (G and
   D, the alphas) within 2 lr for each adam step and with their update
   within STRUCTURAL_UPDATE_RTOL of the CPU's (relative norm), the GAN's
   d_fake_score within STRUCTURAL_SCORE_ATOL.  sp_fedgkt_cifar10 is chaotic
   at its learning rate: its gap is held to STRUCTURAL_CHAOS_RATIO times the
   gap a CPU run opens when its initial weights move by one part in 10^6,
   and the same config at STRUCTURAL_GKT_TIGHT_LR runs too, held to
   STRUCTURAL_CPU_ATOL.  (c) The in-mesh FedNAS round against its sp twin on
   the card in turns (XLA, sp, XLA, sp): the weights and alphas within
   STRUCTURAL_INMESH_ATOL, the genotypes equal, each run's seconds.
18. The IoT autoencoder path and the in-mesh rounds of vertical FL, split
   NN, FedGKT, hierarchical FL and Turbo-Aggregate, with the TF32 flags as
   the script found them.  No flash kernel lies on these paths (no Pallas
   kernel lies on them in the JAX package): the counts, set to 0 when the
   phase starts, must read 0 when it ends.  (a) The six example configs as
   they stand: sp_fedavg_iot_autoencoder (FedAvg of the autoencoder at hidden
   32 and bottleneck 8 on iot_anomaly, adam), xla_vfl_synthetic_lr,
   xla_split_nn_mnist_mlp (split_hidden 128), xla_fedgkt_cifar10_cnn (the
   edge net at width 32, the tower at width 64 with 3 blocks),
   xla_hierarchical_fl_mnist_lr and xla_turbo_aggregate_mnist_lr, each
   through the entry points and again on the CPU: finite losses and trees,
   the final eval beside the CPU's, the seconds; the SGD-driven trees within
   STRUCTURAL_CPU_ATOL (the GKT example, if past it, within
   STRUCTURAL_CHAOS_RATIO times a perturbed CPU run's gap), the autoencoder
   within 2 lr an adam step and its update within IOT_UPDATE_RTOL.  (b)
   nbaiot at its spec's size (115 features, 8,000 train and 1,600 test rows)
   with the IoT example's knobs (adam) and again with SGD at IOT_SPEC_LR, on
   sp and on the packed round, each again on the CPU: test_acc and
   test_anomaly_recall beside the CPU's, the anomaly threshold and the test
   errors' sum within IOT_EVAL_RTOL (adam, past it: within
   STRUCTURAL_CHAOS_RATIO times the largest gap of CPU runs rounded once
   more after every step, and the card again with the CPU's single-tensor adam
   within IOT_EVAL_RTOL).  (c) The in-mesh hierarchical and
   Turbo-Aggregate rounds against their sp twins on the card in turns (XLA,
   sp, XLA, sp), on clients of 64 rows: equal bit for bit, each run's
   seconds.

Any failure raises and the script exits non-zero with no result line.  It
exits 2 when no CUDA device is visible.  Full details go to
chiprun_out/chip_smoke/ beside this script.
"""

from __future__ import annotations

import contextlib
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
# one on the tensor cores (495 TFLOP/s / 3), the route of every fp32 kernel
# (csrc/flash_tf32.cuh) and of PyTorch's fp32 memory-efficient attention; 67
# TFLOP/s, fp32 outside the tensor cores, would be a scalar route's
PEAK_OPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
# tolerance per dtype: |kernel - plain| <= atol + rtol * |plain|, elementwise.
# fp32: the two sum in another order; the kernels' products are split TF32
# (about 21 bits of each operand; tests/test_torch_split_tf32.py), the plain
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
    # phase 14's seq2seq TransformerLM (d_model 128, 4 heads x 32): a training
    # batch of 16 and the eval forward over the example's 102 test sequences,
    # L 24 (src 12 + tgt 12), under one 64-row q tile and one key tile
    ("s2s_train", 16, 24, 4, 32, "float32", True, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    ("s2s_eval", 102, 24, 4, 32, "float32", True, ("flash_fwd",)),
]
# K4 at the sp slice's fold: (name, B, Lq, Lk, H, D, dtype, causal, q shard,
# k shard, padded key tail, key positions permuted).  With shards of Lq keys,
# q shard 1 folds shard 0 (all keys before the rows), itself (the diagonal)
# and shard 2 (all after: dead when causal); past and dead folds carry the
# diagonal fold's state.  The permuted folds take the diagonal shard's
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
    ("fold_permuted_fp32", 8, 256, 256, 16, 64, "float32", True, 1, 1, 0, True),
    ("fold_ragged_full", 4, 200, 130, 8, 32, "float32", False, 1, 0, 17, False),
]
# slice 2: bench.py's TransformerLM leg (bench.py:1465-1502), sequence-parallel
SP_CONFIG = dict(vocab_size=32000, d_model=1024, n_heads=16, n_layers=8, d_ff=4096)
SP_BATCH, SP_LEN, SP_SHARDS, SP_LR = 8, 1024, 4, 1e-3
# sp logits (ring, K4) against single-card logits (K1), fp32 with TF32 off:
# the two sum each row's keys in another order, through 8 layers
SP_PARITY_ATOL = 1e-3
# slice 3: bench.py's _bench_args(1) (bench.py:97-128), 2 rounds instead of 6:
# the third paid for phase 16
BENCH_CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0, "run_id": "bench"},
    "data_args": {"dataset": "cifar10", "data_cache_dir": os.path.join(ROOT, "fedml_data"),
                  "partition_method": "hetero", "partition_alpha": 0.5},
    "model_args": {"model": "resnet56", "compute_dtype": "bf16"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 100,
                   "client_num_per_round": 32, "xla_pack": True, "comm_round": 2, "epochs": 1,
                   "batch_size": 64, "client_optimizer": "sgd", "learning_rate": 0.001},
    "validation_args": {"frequency_of_the_test": 0},
    "device_args": {"device_type": "gpu"},
    "comm_args": {"backend": "XLA"},
}
# phase 8: the clients of round 1's cohort whose packed round runs under
# torch.profiler
PROFILE_CLIENTS = 8
# phase 10a: the algorithm zoo on BENCH_CONFIG, the algorithm's knobs
# changed and the cohort cut to ZOO_COHORT clients (8 until phase 17 was
# added), 2 rounds each
ZOO_ROUNDS = 2
ZOO_COHORT = 4
ZOO = [
    ("FedProx", {"federated_optimizer": "FedProx", "proximal_mu": 0.01}),
    ("FedOpt", {"federated_optimizer": "FedOpt", "server_optimizer": "adam",
                "server_lr": 0.01}),
    ("FedNova", {"federated_optimizer": "FedNova"}),
    ("SCAFFOLD", {"federated_optimizer": "SCAFFOLD"}),
    ("FedDyn", {"federated_optimizer": "FedDyn", "feddyn_alpha": 0.01}),
    ("AsyncFedAvg", {"federated_optimizer": "Async_FedAvg"}),
    ("FedBuff", {"fl_mode": "async", "async_buffer_size": 4, "async_max_staleness": 2,
                 "async_staleness_policy": "polynomial"}),
]
# SCAFFOLD's c and FedDyn's h are the mean of their client tables, up to the
# fp32 sums that build each (ZOO_COHORT clients a round, the table by index_add_):
# max |c - mean_i c_i| <= ZOO_MEAN_RTOL * max |c_i|
ZOO_MEAN_RTOL = 1e-5
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


def fold_args(fa, B, Lq, Lk, H, D, dtype_name, causal, q_shard, k_shard, tail, perm):
    """The arguments of one fold case of FOLD_CASES (its row without the
    name): (q, k, v, q_pos, k_pos, m, l, o, causal) on the card."""
    import torch

    dtype = getattr(torch, dtype_name)
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
    return q, k, v, q_pos, k_pos, m, l, o, causal


def fold_phase(fa):
    """K4 against its plain twin at every fold case; returns per-case rows."""
    import torch

    rows = []
    for case, B, Lq, Lk, H, D, dtype_name, causal, q_shard, k_shard, tail, perm in FOLD_CASES:
        tol = TOLERANCE[dtype_name]
        args = fold_args(fa, B, Lq, Lk, H, D, dtype_name, causal, q_shard, k_shard, tail, perm)
        q_pos, k_pos, m, l, o = args[3:8]
        poison(m, l, o)
        before = dict(fa.LAUNCHES)
        got = fa.flash_shard_update_cuda(*args)
        torch.cuda.synchronize()
        moved = [n for n in fa.LAUNCHES if fa.LAUNCHES[n] != before[n]]
        if len(moved) != 1:
            raise AssertionError(f"{case}: launch counters moved {moved}")
        want = fa.flash_shard_update_plain(*args)
        scale = want[1].clamp_min(1.0).permute(0, 2, 1)[..., None]
        err, least_atol = worst(check_close(f"{case} m", got[0], want[0], tol["m"]),
                       check_close(f"{case} l", got[1], want[1], tol["l"]),
                       check_close(f"{case} o", got[2], want[2], tol["fold_o"], scale))
        o_err_over_l = float(((got[2] - want[2]).abs() / scale).max().item())
        live = (k_pos >= 0)[None, :] & ((q_pos[:, None] >= k_pos[None, :]) | (not causal))
        live_pairs = int(live.sum().item())
        b_ms, b_by = bound_fold(B, H, D, dtype_name, live)
        row = {"case": case, "kernel": moved[0], "shape": [B, Lq, Lk, H, D],
               "dtype": dtype_name, "causal": causal, "shards": [q_shard, k_shard],
               "live_pairs_per_bh": live_pairs, "max_abs_err": err, "least_atol": least_atol,
               "o_err_over_l": o_err_over_l,
               "ms": time_ms(lambda: fa.flash_shard_update_cuda(*args), 30),
               # about 30 launches a call: 10 calls stay inside the card's launch queue
               "plain_ms": time_ms(lambda: fa.flash_shard_update_plain(*args), 10),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        rows.append(row)
        log(f"  {case:18s} {moved[0]:18s} {dtype_name:8s} live pairs {live_pairs:6d} err {err:.3e} "
            f"(o over max(l, 1) {o_err_over_l:.3e}, least atol {least_atol:.3e})  kernel "
            f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        del got, want, args
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


def packed_reference_phase(ft):
    """One packed FedAvg round of a ResNet-20 in fp32 on the card and on the
    CPU: 8 clients of 32 cifar10 images, batch 16 (2 batches each), TF32 off
    (the simulator pins it on the card), the CPU run's initial weights on
    both.  The shuffles are host numpy, so the runs differ only by the
    convolutions' sums."""
    import copy

    import torch

    config = copy.deepcopy(BENCH_CONFIG)
    config["data_args"].update(partition_method="homo", synthetic_train_size=256)
    config["model_args"].update(model="resnet20", compute_dtype="fp32")
    config["train_args"].update(client_num_in_total=8, client_num_per_round=8, comm_round=1,
                                batch_size=16)
    finals, init = {}, None
    for dev_type in ("cpu", "gpu"):
        config["device_args"]["device_type"] = dev_type
        args = ft.init(ft.Arguments.from_dict(copy.deepcopy(config)), should_init_logs=False)
        device = ft.device.get_device(args)
        dataset, classes = ft.data.load(args)
        runner = ft.FedMLRunner(args, device, dataset, ft.models.hub.create(args, classes))
        sim = runner.runner.sim
        if init is None:
            init = {k: v.clone() for k, v in sim.variables.items()}
        sim.variables = {k: v.to(device) for k, v in init.items()}
        runner.run()
        finals[dev_type] = ({k: v.float().cpu() for k, v in sim.variables.items()},
                            sim.round_losses[0], int(sim._s_bucket))
    worst = 0.0
    for name, g in finals["gpu"][0].items():
        err = (g - finals["cpu"][0][name]).abs().max().item()
        if err > 1e-4:
            raise AssertionError(f"packed reference: {name} differs card vs CPU by {err:.3e}")
        worst = max(worst, err)
    log(f"  packed ResNet-20 round card vs CPU ({finals['gpu'][2]} steps): loss "
        f"{finals['gpu'][1]:.6f} vs {finals['cpu'][1]:.6f}; max |param diff| {worst:.3e} "
        f"(atol 1e-4)")
    return {"max_param_diff": worst, "loss_card": finals["gpu"][1],
            "loss_cpu": finals["cpu"][1], "tf32": {
                "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}}


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
    logits (the sp forward under torch.profiler, for the fp32 K4's device
    time), then one warm and 3 timed bf16 SGD steps; the counts are set to 0
    just before the sp forward and read after the last step.  One more step
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as fwd_prof:
            logits = sp_apply(cfg, params, tokens, mesh)
            torch.cuda.synchronize()
    fwd_launches = dict(fa.LAUNCHES)
    fwd_fold = [e for e in fwd_prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "flash_update_kernel" in e.key]
    fwd_fold_ms = sum(e.self_device_time_total for e in fwd_fold) / 1e3
    log(f"  fp32 sp forward under the profiler: K4 fp32 {fwd_fold_ms:.3f} ms of device time in "
        f"{sum(e.count for e in fwd_fold)} launches")
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
                      "forward_launches": fwd_launches, "forward_fold_ms": fwd_fold_ms,
                      "launches": launches, "losses": losses,
                      "step_seconds": step_s, "median_step_s": timed,
                      "tokens_per_s": tokens_per_s, "peak_memory_bytes": peak,
                      "profile": {"wall_ms": wall_ms, "device_ms": device_ms, "fold_ms": fold_ms,
                                  "top": table}}

# device-kernel families of the ResNet round, by substrings of kernel names
KERNEL_FAMILIES = (
    ("groupnorm", ("groupnorm", "group_norm", "rowwisemoments", "computefusedparams",
                   "compute1dbackward", "computeinternalgradients", "computebackward",
                   "gammabeta")),
    ("convolution", ("cudnn", "xmma", "implicit_gemm", "wgrad", "dgrad", "fprop", "conv2d",
                     "convolution", "nchwtonhwc", "nhwctonchw", "cutlass")),
    ("elementwise and reductions", ("elementwise", "multi_tensor_apply", "reduce_kernel")),
)


def kernel_family(name: str) -> str:
    low = name.lower()
    for family, keys in KERNEL_FAMILIES:
        if any(k in low for k in keys):
            return family
    return "other"


def resnet_slice_phase(ft, fa):
    """bench.py's north-star configuration through the port's entry points
    (BENCH_CONFIG).  The counts are set to 0 before the run and read after:
    this path launches no flash kernel."""
    import copy

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    fa.reset_launches()
    args = ft.init(ft.Arguments.from_dict(copy.deepcopy(BENCH_CONFIG)), should_init_logs=False)
    device = ft.device.get_device(args)
    t0 = time.perf_counter()
    dataset, classes = ft.data.load(args)
    data_s = time.perf_counter() - t0
    model = ft.models.hub.create(args, classes)
    t0 = time.perf_counter()
    runner = ft.FedMLRunner(args, device, dataset, model)
    sim = runner.runner.sim
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in sim.variables.values())
    log(f"  data: {dataset[0]} train / {dataset[1]} test images {dataset[2][0].shape[1:]} "
        f"generated in {data_s:.2f} s (synthetic: {args.dataset_is_synthetic}); simulator built "
        f"in {pack_s:.2f} s: x_all {tuple(sim.x_all.shape)} {sim.x_all.dtype}, "
        f"{n_params:,} params, s_max {sim.s_max}")
    if sim.x_all.dtype is not torch.bfloat16 or not sim.packed:
        raise AssertionError(f"x_all {sim.x_all.dtype}, packed {sim.packed}")
    # a gathered batch is the fp32 batch cast to bf16, bit for bit
    for cid in (0, sim.num_clients // 2, sim.num_clients - 1):
        k = min(64, int(sim.client_counts[cid]))
        rows = torch.from_numpy(sim._client_rows[cid][:k].astype(np.int64)).to(device)
        want = torch.from_numpy(dataset[5][cid][0][:k]).to(device=device, dtype=torch.bfloat16)
        if not torch.equal(sim.x_all.index_select(0, rows).view(torch.int16),
                           want.view(torch.int16)):
            raise AssertionError(f"client {cid}: the bf16 rows are not the fp32 rows cast")

    streams = []
    packed_inputs = sim._packed_inputs

    def recorded(ids, counts, round_idx):
        sched = packed_inputs(ids, counts, round_idx)
        streams.append({"round": round_idx, "steps": int(sched.n_steps),
                        "s_bucket": int(sim._s_bucket), "clients": len(ids),
                        "samples": int(counts.sum())})
        return sched

    sim._packed_inputs = recorded
    before = dict(fa.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    runner.run()
    sim._packed_inputs = packed_inputs
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()) or any(before.values()):
        raise AssertionError(f"a flash kernel launched on slice 3's path: {launches}")
    if len(sim.round_losses) != int(args.comm_round) or not all(
            math.isfinite(x) for x in sim.round_losses):
        raise AssertionError(f"train losses {sim.round_losses}")
    tp = sim.throughput()
    for st, dt, loss in zip(streams, sim.round_times, sim.round_losses):
        log(f"  round {st['round']}: {dt:.4f} s, {st['steps']} steps (bucket {st['s_bucket']}), "
            f"{st['samples']} samples of {st['clients']} clients, loss {loss:.6f}")
    log(f"  throughput {json.dumps(tp)}; peak memory {peak / 2**30:.3f} GiB; "
        f"flash launches {launches}")

    sampled = sim._client_sampling(1)
    ids, real = sim._schedule(sampled)
    counts = np.where(real > 0, sim.client_counts[ids], 0)
    # the first PROFILE_CLIENTS of round 1's cohort (its shapes ran in the run
    # above) once more, under the profiler; its events are summed from the
    # raw kineto records (key_averages() takes minutes over a round's ~10^6)
    ids, counts = ids[:PROFILE_CLIENTS], counts[:PROFILE_CLIENTS]
    steps = int(sim._packed_inputs(ids, counts, 1).n_steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(sim._run_packed_round(1, ids, counts))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict = {}  # name -> [device ms, launches]
    ops: dict = {}  # aten op -> calls
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += e.duration_ns() / 1e6
            k[1] += 1
        elif e.name().startswith("aten::"):
            ops[e.name()] = ops.get(e.name(), 0) + 1
    device_ms = sum(ms for ms, _ in kernels.values())
    families: dict = {}
    for name, (ms, _) in kernels.items():
        families[kernel_family(name)] = families.get(kernel_family(name), 0.0) + ms
    median_round_ms = 1e3 * tp["median_round_s"]
    log(f"  {len(ids)} of round 1's clients under the profiler ({steps} steps): wall "
        f"{wall_ms:.1f} ms, device busy {device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f} %; "
        f"{100 * device_ms / median_round_ms * streams[1]['steps'] / steps:.1f} % of the "
        "unprofiled median round, scaled by its steps); by family "
        + json.dumps({k: round(v, 3) for k, v in sorted(families.items())}))
    top = []
    for name, (ms, calls) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:16]:
        top.append({"name": name, "device_ms": ms, "calls": calls, "family": kernel_family(name)})
        log(f"    {ms:9.3f} ms  {calls:7d}x  {name[:90]}")
    op_table = sorted(ops.items(), key=lambda kv: -kv[1])[:16]
    log(f"  aten ops a step: {sum(ops.values()) / steps:.0f}; the most called: " + ", ".join(
        f"{name} {calls / steps:.0f}" for name, calls in op_table))

    # GroupNorm on a channels_last input, as the model gives it: the ops it
    # runs (a contiguous copy or not) and the layout of its output
    xg = torch.randn(64, 16, 32, 32, device=device).contiguous(memory_format=torch.channels_last)
    wg, bg = torch.ones(16, device=device), torch.zeros(16, device=device)
    with profile(activities=[ProfilerActivity.CPU]) as gprof:
        yg = F.group_norm(xg, 1, wg, bg, 1e-6)
    gn = {"ops": [e.name() for e in gprof.profiler.kineto_results.events()
                  if e.name().startswith("aten::") and e.name() not in ("aten::empty",
                                                                         "aten::view")],
          "output_channels_last": yg.is_contiguous(memory_format=torch.channels_last),
          "output_contiguous": yg.is_contiguous()}
    log(f"  group_norm on a channels_last [64, 16, 32, 32] input: {json.dumps(gn)}")

    # the boundary flush (acc += w * params; params <- round start), alone
    params = [p for p in model.parameters()]
    acc = [torch.zeros_like(p) for p in params]
    start = [p.detach().clone() for p in params]

    def flush():
        with torch.no_grad():
            torch._foreach_add_(acc, params, alpha=3.0)
            torch._foreach_copy_(params, start)

    flush_ms = time_ms(flush)
    log(f"  one boundary flush ({len(params)} tensors, {n_params:,} params): {flush_ms:.4f} ms; "
        f"{streams[1]['clients']} a round: {flush_ms * streams[1]['clients']:.3f} ms")
    return {"params": n_params, "data_seconds": data_s, "build_seconds": pack_s,
            "streams": streams, "round_times": list(sim.round_times),
            "round_losses": list(sim.round_losses), "throughput": tp,
            "peak_memory_bytes": peak, "launches": launches,
            "profile": {"wall_ms": wall_ms, "device_ms": device_ms, "steps": steps,
                        "families_ms": families, "top": top, "ops_per_round": dict(op_table)},
            "group_norm": gn,
            "flush_ms": flush_ms, "flushes_per_round": streams[1]["clients"]}, (dataset, classes)


def packed_zoo_reference_phase(ft):
    """2 packed rounds of SCAFFOLD and of FedNova on phase 3's ResNet-20
    (fp32, TF32 off) on the card and on the CPU, the CPU run's initial
    weights on both: params, server state and client-state table agree
    within 1e-4 in the units of the params.  A control variate is a params
    delta over K * lr (K 2 steps a client here, lr 0.001), so its
    difference is held to 1e-4 / (K * lr): 1e-4 once multiplied back."""
    import copy

    import torch

    config = copy.deepcopy(BENCH_CONFIG)
    config["data_args"].update(partition_method="homo", synthetic_train_size=256)
    config["model_args"].update(model="resnet20", compute_dtype="fp32")
    config["train_args"].update(client_num_in_total=8, client_num_per_round=8, comm_round=2,
                                batch_size=16)
    # 256 images over 8 clients at batch 16: every client takes 2 steps
    k_lr = 2 * float(config["train_args"]["learning_rate"])
    atol = {"params": 1e-4, "server state": 1e-4 / k_lr, "client state": 1e-4 / k_lr}
    out = {}
    for name in ("SCAFFOLD", "FedNova"):
        config["train_args"]["federated_optimizer"] = name
        finals, init = {}, None
        for dev_type in ("cpu", "gpu"):
            config["device_args"]["device_type"] = dev_type
            args = ft.init(ft.Arguments.from_dict(copy.deepcopy(config)), should_init_logs=False)
            device = ft.device.get_device(args)
            dataset, classes = ft.data.load(args)
            runner = ft.FedMLRunner(args, device, dataset, ft.models.hub.create(args, classes))
            sim = runner.runner.sim
            if init is None:
                init = {k: v.clone() for k, v in sim.variables.items()}
            sim.variables = {k: v.to(device) for k, v in init.items()}
            runner.run()
            finals[dev_type] = {
                "params": {k: v.float().cpu() for k, v in sim.variables.items()},
                "server state": {k: v.cpu() for k, v in dict(sim.server_state).items()},
                "client state": {k: v.cpu() for k, v in (sim.client_state or {}).items()},
                "losses": list(sim.round_losses)}
        worst = {}
        for what in ("params", "server state", "client state"):
            worst[what] = 0.0
            for k, g in finals["gpu"][what].items():
                err = (g - finals["cpu"][what][k]).abs().max().item()
                if err > atol[what]:
                    raise AssertionError(f"packed {name} reference: {what} {k} differs card vs "
                                         f"CPU by {err:.3e} > {atol[what]:.3g}")
                worst[what] = max(worst[what], err)
        if name == "SCAFFOLD" and not (finals["gpu"]["server state"]
                                       and finals["gpu"]["client state"]):
            raise AssertionError("SCAFFOLD kept no server or client state")
        log(f"  packed ResNet-20 {name}, 2 rounds, card vs CPU: losses "
            f"{finals['gpu']['losses']} vs {finals['cpu']['losses']}; max |diff| "
            + ", ".join(f"{w} {e:.3e} (atol {atol[w]:.3g})" for w, e in worst.items()))
        if any(int(n) != 32 for n in dataset[4].values()):
            raise AssertionError(f"the clients do not take 2 steps each: {dataset[4]}")
        out[name] = {"max_diff": worst, "atol": atol, "losses_card": finals["gpu"]["losses"],
                     "losses_cpu": finals["cpu"]["losses"]}
    return out


def _norm(tree) -> float:
    """The 2-norm over every tensor of a (nested) state; 0 for ()."""
    import torch

    if isinstance(tree, dict):
        return math.sqrt(sum(_norm(v) ** 2 for v in tree.values()))
    return float(torch.linalg.vector_norm(tree.float())) if hasattr(tree, "float") else 0.0


def _zoo_runner(ft, config, knobs, dataset, classes):
    import copy

    config = copy.deepcopy(config)
    config["train_args"].update(knobs)
    args = ft.init(ft.Arguments.from_dict(config), should_init_logs=False)
    device = ft.device.get_device(args)
    return ft.FedMLRunner(args, device, dataset, ft.models.hub.create(args, classes))


def _mean_invariant(sim) -> dict:
    """max |s - mean_i s_i| of the server state against the client table
    (SCAFFOLD's c, FedDyn's h), the mean taken in float64."""
    err = scale = 0.0
    for k, table in sim.client_state.items():
        mean = table.double().mean(0)
        err = max(err, (sim.server_state[k].double() - mean).abs().max().item())
        scale = max(scale, table.abs().max().item())
    if not err <= ZOO_MEAN_RTOL * scale:
        raise AssertionError(f"{type(sim.algo).__name__}: max |state - mean of the table| "
                             f"{err:.3e} > {ZOO_MEAN_RTOL} * {scale:.3e}")
    return {"max_abs_diff": err, "table_max_abs": scale}


def _aten_ops_per_step(sim, ids, counts) -> dict:
    """aten ops a step, by op, of one packed round of the sim over the given
    clients, from torch.profiler's raw records (phase 8's count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cex = sim.algo.gather_client_extras(sim.client_state, ids, (counts > 0).astype(np.float32), 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        float(sim._run_packed_round(1, ids, counts, cex))
    steps = int(sim._packed_inputs(ids, counts, 1).n_steps)
    ops: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("aten::"):
            ops[e.name()] = ops.get(e.name(), 0) + 1 / steps
    return ops


def zoo_phase(ft, fa, dataset, classes):
    """Phase 10a: every zoo member at the north-star width, a cohort of
    ZOO_COHORT, 2 rounds each through the entry points, on phase 8's
    dataset; FedAvg's round and SCAFFOLD's alternated on one cohort; the aten
    ops a step of the hooked members."""
    import copy

    import torch

    fa.reset_launches()
    config = copy.deepcopy(BENCH_CONFIG)
    config["train_args"].update(comm_round=ZOO_ROUNDS, client_num_per_round=ZOO_COHORT)
    members, sims = {}, {}
    for name, knobs in ZOO:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # the sims kept from earlier members
        runner = _zoo_runner(ft, config, knobs, dataset, classes)
        sim = runner.runner.sim
        runner.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        finite = all(bool(torch.isfinite(v).all()) for v in sim.variables.values())
        if not finite or len(sim.round_losses) != ZOO_ROUNDS or not all(
                math.isfinite(x) for x in sim.round_losses):
            raise AssertionError(f"{name}: losses {sim.round_losses}, finite params {finite}")
        entry = {"algorithm": type(sim.algo).__name__, "round_seconds": list(sim.round_times),
                 "throughput": sim.throughput(), "losses": list(sim.round_losses),
                 "samples_per_round": list(sim.samples_per_round),
                 "server_state_norm": _norm(sim.server_state), "wall_seconds": wall,
                 "peak_memory_bytes": torch.cuda.max_memory_allocated() - base}
        if sim.client_state is not None:
            entry["mean_invariant"] = _mean_invariant(sim)
        if sim.async_mode:
            entry["flushes"] = [{"clients": len(stal), "staleness": sorted(stal.values())}
                                for stal in sim.async_flushes]
            entry["dropped_stale"] = sim._async_dropped_stale
        members[name] = entry
        log(f"  {name} ({entry['algorithm']}): rounds "
            f"{[round(t, 4) for t in sim.round_times]} s, {sim.samples_per_round} samples, "
            f"{entry['throughput']['samples_per_sec']:.1f} samples/s, peak memory "
            f"{entry['peak_memory_bytes'] / 2**30:.3f} GiB; losses "
            f"{[round(x, 6) for x in sim.round_losses]}; params finite; server state norm "
            f"{entry['server_state_norm']:.6g}"
            + (f"; mean invariant {entry['mean_invariant']}" if "mean_invariant" in entry else "")
            + (f"; flushes {entry['flushes']}, {entry['dropped_stale']} arrivals dropped as "
               "too stale" if "flushes" in entry else ""))
        if name in ("FedProx", "SCAFFOLD", "FedDyn"):
            sims[name] = sim
        del runner, sim  # the next member's base holds only the kept sims
    launches = dict(fa.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"a flash kernel launched on the zoo's ResNet-56 path: {launches}")

    # FedAvg's round against SCAFFOLD's on one cohort, in turns
    sims["FedAvg"] = _zoo_runner(ft, config, {"comm_round": 1}, dataset, classes).runner.sim
    sampled = sims["FedAvg"]._client_sampling(1)
    ids, real = sims["FedAvg"]._schedule(sampled)
    counts = np.where(real > 0, sims["FedAvg"].client_counts[ids], 0)
    turns = []
    for name in ("FedAvg", "FedAvg", "SCAFFOLD", "FedAvg"):  # the first warms
        sim = sims[name]
        cex = sim.algo.gather_client_extras(sim.client_state, ids,
                                            (counts > 0).astype(np.float32), 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(sim._run_packed_round(1, ids, counts, cex))
        turns.append({"algorithm": name, "seconds": time.perf_counter() - t0, "loss": loss})
    turns = turns[1:]
    fedavg_s = statistics.mean(t["seconds"] for t in turns if t["algorithm"] == "FedAvg")
    scaffold_s = statistics.mean(t["seconds"] for t in turns if t["algorithm"] == "SCAFFOLD")
    log(f"  one cohort ({int(counts.sum())} samples), in turns: " + ", ".join(
        f"{t['algorithm']} {t['seconds']:.4f} s" for t in turns)
        + f"; SCAFFOLD over FedAvg {scaffold_s / fedavg_s:.4f}")

    # aten ops a step over a 2-client stream, FedAvg against the hooked members
    by_op = {name: _aten_ops_per_step(sims[name], ids[:2], counts[:2])
             for name in ("FedAvg", "FedProx", "SCAFFOLD", "FedDyn")}
    ops, added = {}, {}
    for name, counts_ in by_op.items():
        ops[name] = sum(counts_.values())
        delta = {op: counts_.get(op, 0) - by_op["FedAvg"].get(op, 0)
                 for op in set(counts_) | set(by_op["FedAvg"])}
        added[name] = dict(sorted(delta.items(), key=lambda kv: -abs(kv[1]))[:6])
    log("  aten ops a step (2 clients): " + "; ".join(
        f"{name} {ops[name]:.1f} ({ops[name] - ops['FedAvg']:+.1f}: "
        + ", ".join(f"{op} {d:+.1f}" for op, d in added[name].items() if abs(d) >= 0.05) + ")"
        for name in ops))
    return {"members": members, "turns": turns, "scaffold_over_fedavg": scaffold_s / fedavg_s,
            "aten_ops_per_step": ops, "aten_ops_added": added, "flash_launches": launches}


def zoo_hooks_phase(ft, fa):
    """Phase 10b: SCAFFOLD and FedDyn, 2 rounds each, on slice 1's
    configuration: the grad hooks run inside steps that launch K1-K3 (fp32).
    The counts are set to 0 before and read after both runs."""
    import copy

    import torch

    config = copy.deepcopy(SLICE_CONFIG)
    config["train_args"]["comm_round"] = ZOO_ROUNDS
    config["validation_args"]["frequency_of_the_test"] = 0
    args = ft.init(ft.Arguments.from_dict(copy.deepcopy(config)), should_init_logs=False)
    dataset, classes = ft.data.load(args)
    fa.reset_launches()
    out = {}
    for name, knobs in ZOO:
        if name not in ("SCAFFOLD", "FedDyn"):
            continue
        runner = _zoo_runner(ft, config, knobs, dataset, classes)
        sim = runner.runner.sim
        runner.run()
        torch.cuda.synchronize()
        if not all(math.isfinite(x) for x in sim.round_losses) or not all(
                bool(torch.isfinite(v).all()) for v in sim.variables.values()):
            raise AssertionError(f"{name} on slice 1: losses {sim.round_losses}")
        out[name] = {"round_seconds": list(sim.round_times), "losses": list(sim.round_losses),
                     "mean_invariant": _mean_invariant(sim)}
        log(f"  {name} on slice 1: rounds {[round(t, 4) for t in sim.round_times]} s, losses "
            f"{[round(x, 6) for x in sim.round_losses]}, mean invariant "
            f"{out[name]['mean_invariant']}")
    launches = dict(fa.LAUNCHES)
    for name in SLICE1_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched under the grad hooks")
    if any(launches[name] for name in launches if name not in SLICE1_KERNELS):
        raise AssertionError(f"a bf16 kernel or the ring's fold launched: {launches}")
    log(f"  launches {launches}")
    return launches, out


# phase 11: the trust path on BENCH_CONFIG (byzantine_client_num 10), 2
# rounds a run: (name, the knobs changed)
TRUST_ROUNDS = 1
TRUST_HOOKS_ROUNDS = 2  # phase 11c
TRUST_BASE = {"byzantine_client_num": 10}
TRUST = [
    ("byzantine_random_krum", {"enable_attack": True, "attack_type": "byzantine",
                               "attack_mode": "random", "enable_defense": True,
                               "defense_type": "krum"}),
    ("label_flipping_trimmed_mean", {"enable_attack": True, "attack_type": "label_flipping",
                                     "enable_defense": True,
                                     "defense_type": "coordinate_wise_trimmed_mean"}),
    ("model_replacement_clipping", {"enable_attack": True, "attack_type": "model_replacement",
                                    "enable_defense": True, "defense_type": "norm_diff_clipping"}),
    ("fednova_backdoor_foolsgold", {"federated_optimizer": "FedNova", "enable_attack": True,
                                    "attack_type": "backdoor", "enable_defense": True,
                                    "defense_type": "foolsgold"}),
    # bulyan needs n >= 4f + 3 (32 >= 31): f 7; with 10 its trimmed set is 1 row
    ("padded_scaffold_bulyan", {"federated_optimizer": "SCAFFOLD", "xla_pack": False,
                                "enable_defense": True, "defense_type": "bulyan",
                                "byzantine_client_num": 7}),
    # 1 round x 32 clients x epsilon 10: the budget ends exactly with the run
    ("ldp_gaussian", {"enable_dp": True, "dp_type": "ldp", "mechanism_type": "gaussian",
                      "epsilon": 10.0, "delta": 1e-5, "sensitivity": 0.1,
                      "privacy_budget": [320.0, 1.0]}),
    ("cdp_laplace", {"enable_dp": True, "dp_type": "cdp", "mechanism_type": "laplace",
                     "epsilon": 10.0, "sensitivity": 0.01}),
]
# phase 11b: every stacked rule on one captured round's stack, card against
# CPU on the same inputs and draws.  fp32 both sides; the two sum 32 rows and
# 855,770 coordinates in other orders (relative roundoff ~1e-7 a sum, up to
# 32 * 2^-24 = 1.9e-6 over the rows), and the outputs are params of |x| <~ 1:
# |card - cpu| <= 1e-5 + 1e-5 |cpu| leaves 5x room over the worst case.
# krum's scores take the Gram form |a|^2 + |b|^2 - 2 a.b of the raw params,
# whose fp32 roundoff scales with |a|^2, not with the distance: each
# distance carries up to ~20 * 2^-24 * 4 max_i |x_i|^2 (a blocked sum of
# 855,770 terms), a score of k of them k times that.  Scores are held to
# TRUST_SCORE_RTOL * k * max_i |x_i|^2; where the two sides' selections
# differ, each card pick must score within that of the CPU's best, and the
# rule's arithmetic after the selection is held to TRUST_TOL on the card's
# selection.
# foolsgold's trust weights are a logit of 1 - the largest cosine
# similarity, whose slope 1 / (w (1 - w)) reaches 101 at its cap w = 0.99:
# a cosine's roundoff (~20 * 2^-24 over 855,770 terms, 1.2e-6) becomes
# 1.2e-4 in a weight.  The weights are held to that bound, the aggregate to
# TRUST_TOL on the card's weights.
TRUST_TOL = (1e-5, 1e-5)
TRUST_SCORE_RTOL = 5e-6
TRUST_FOOLSGOLD_WEIGHT_TOL = (2e-4, 0.0)
TRUST_DEFENSES = [
    ("krum", {}), ("multi_krum", {"krum_param_m": 16}), ("norm_diff_clipping", {}),
    ("3sigma", {}), ("wbc", {}), ("geometric_median", {}), ("rfa", {}), ("cclip", {}),
    ("slsgd", {}), ("foolsgold", {}), ("robust_learning_rate", {}),
    ("coordinate_wise_median", {}), ("coordinate_wise_trimmed_mean", {}),
    ("bulyan", {"byzantine_client_num": 7}), ("weak_dp", {}),
    ("soteria", {"soteria_layer": ("classifier", "kernel")}),
]
TRUST_ATTACKS = [
    ("byzantine", {"attack_mode": "zero"}), ("byzantine", {"attack_mode": "random"}),
    ("byzantine", {"attack_mode": "flip"}), ("model_replacement", {}),
    ("backdoor", {"attack_mode": "craft"}), ("backdoor", {"attack_mode": "clip"}),
    ("edge_case_backdoor", {}),
]


def _trust_runner(ft, knobs, dataset, classes):
    import copy

    config = copy.deepcopy(BENCH_CONFIG)
    config["train_args"].update(TRUST_BASE, comm_round=TRUST_ROUNDS)
    return _zoo_runner(ft, config, knobs, dataset, classes)


def trust_phase(ft, fa, dataset, classes):
    """Phase 11a: each trust run through the entry points at the north-star
    width, TRUST_ROUNDS rounds, its peak memory against a FedAvg round's;
    FedAvg's round and the defended one (byzantine + krum) alternated on one cohort.  Phase
    11b: one captured round's stack through every stacked rule, card against
    CPU."""
    import torch

    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
    from fedml_tpu_torch.core.security.fedml_attacker import FedMLAttacker

    fa.reset_launches()
    # FedAvg's sim (no knob of the trust path) and its peak over one round
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fedavg = _zoo_runner(ft, BENCH_CONFIG, {"comm_round": 1}, dataset, classes).runner.sim
    sampled = fedavg._client_sampling(0)
    ids, real = fedavg._schedule(sampled)
    counts = np.where(real > 0, fedavg.client_counts[ids], 0)
    float(fedavg._run_packed_round(0, ids, counts))  # also warms the turns below
    torch.cuda.synchronize()
    fedavg_peak = torch.cuda.max_memory_allocated() - base
    log(f"  FedAvg: one round's peak {fedavg_peak / 2**30:.3f} GiB")
    runs, sims, captured = {}, {}, {}
    for name, knobs in TRUST:
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # the sims kept from earlier runs
        runner = _trust_runner(ft, knobs, dataset, classes)
        sim = runner.runner.sim
        cohorts = []
        sampling = sim._client_sampling

        def sampled(round_idx, sampling=sampling, cohorts=cohorts):
            ids = sampling(round_idx)
            cohorts.append(sorted(int(c) for c in ids))
            return ids

        sim._client_sampling = sampled
        if name == "byzantine_random_krum":
            security = sim._security_round

            def capture(round_idx, mat_all, taus, ids, counts, cex, ext, security=security):
                real = np.where(counts > 0)[0]
                captured.update(
                    mat=mat_all[torch.as_tensor(real, device=mat_all.device)].clone(),
                    w=counts[real].astype(np.float32),
                    mal=np.array([float(int(ids[i]) in sim._byzantine) for i in real],
                                 np.float32),
                    variables={k: v.clone() for k, v in sim.variables.items()})
                return security(round_idx, mat_all, taus, ids, counts, cex, ext)

            sim._security_round = capture
        runner.run()
        torch.cuda.synchronize()
        sim.__dict__.pop("_security_round", None)
        peak = torch.cuda.max_memory_allocated() - base
        finite = all(bool(torch.isfinite(v).all()) for v in sim.variables.values())
        if not finite or len(sim.round_losses) != TRUST_ROUNDS or not all(
                math.isfinite(x) for x in sim.round_losses):
            raise AssertionError(f"{name}: losses {sim.round_losses}, finite params {finite}")
        attacker = FedMLAttacker.get_instance()
        entry = {"algorithm": type(sim.algo).__name__, "packed": sim.packed,
                 "round_seconds": list(sim.round_times), "losses": list(sim.round_losses),
                 "samples_per_round": list(sim.samples_per_round),
                 "peak_memory_bytes": peak, "peak_over_fedavg_bytes": peak - fedavg_peak,
                 "wall_seconds": time.perf_counter() - t0}
        if sim.needs_stack:
            entry["security_ms"] = list(sim.security_ms)
            if len(sim.security_ms) != TRUST_ROUNDS:
                raise AssertionError(f"{name}: the security tail ran {sim.security_ms}")
        if attacker.is_attack_enabled():
            bad = attacker.get_byzantine_idxs(sim.num_clients)
            entry["byzantine_idxs"] = bad
            if attacker.is_data_poisoning_attack() and sim.poisoned_clients != bad:
                raise AssertionError(f"{name}: poisoned {sim.poisoned_clients} != {bad}")
            if attacker.is_model_attack():
                want = [sorted(set(c) & set(bad)) for c in cohorts]
                if sim.malicious_per_round != want or not any(want):
                    raise AssertionError(f"{name}: malicious {sim.malicious_per_round} != "
                                         f"get_byzantine_idxs in the cohort {want}")
                entry["malicious_per_round"] = sim.malicious_per_round
        if sim.defended and sim._defense.t == "foolsgold":
            hist = sim._defense_state["fg_hist"]
            dim = sum(v.numel() for v in sim.variables.values())
            if tuple(hist.shape) != (sim.clients_per_round, dim) or not bool(
                    torch.isfinite(hist).all()) or float(hist.abs().sum()) == 0.0:
                raise AssertionError(f"{name}: foolsgold history {tuple(hist.shape)}")
            entry["foolsgold_history_norm"] = float(torch.linalg.vector_norm(hist))
        dp = FedMLDifferentialPrivacy.get_instance()
        if dp.is_dp_enabled:
            entry["dp"] = {"type": dp.dp_type, "noise_scale": dp.noise_scale(),
                           "spends": len(dp.accountant), "spent": dp.accountant.total(),
                           "remaining": dp.accountant.remaining}
            if dp.is_local_dp_enabled() and (
                    len(dp.accountant) != TRUST_ROUNDS * sim.clients_per_round
                    or abs(dp.accountant.remaining[0]
                           - (knobs["privacy_budget"][0] - 10.0 * len(dp.accountant)))
                    > 1e-9):
                raise AssertionError(f"{name}: the accountant spent {entry['dp']}")
            if dp.is_global_dp_enabled() and len(dp.accountant) != TRUST_ROUNDS:
                raise AssertionError(f"{name}: central DP spent {entry['dp']}")
        runs[name] = entry
        log(f"  {name} ({entry['algorithm']}, {'packed' if sim.packed else 'padded'}): rounds "
            f"{[round(t, 4) for t in sim.round_times]} s, {sim.samples_per_round} samples; "
            f"security tail {[round(t, 3) for t in entry.get('security_ms', [])]} ms; peak "
            f"{peak / 2**30:.3f} GiB ({(peak - fedavg_peak) / 2**20:+.1f} MiB over FedAvg); "
            f"losses {[round(x, 6) for x in sim.round_losses]}"
            + (f"; malicious {entry['malicious_per_round']}" if "malicious_per_round" in entry
               else "")
            + (f"; dp {entry['dp']}" if "dp" in entry else ""))
        if name == "byzantine_random_krum":
            sims[name] = sim
        del runner, sim
    launches = dict(fa.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"a flash kernel launched on the trust path's ResNet-56: {launches}")

    # FedAvg's round and the defended round, in turns on round 0's cohort,
    # which both sims ran already (FedAvg's peak round, krum's round 0)
    defended = sims["byzantine_random_krum"]
    turns = []
    for label, sim in (("FedAvg", fedavg), ("krum", defended), ("FedAvg", fedavg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(sim._run_packed_round(0, ids, counts))
        torch.cuda.synchronize()
        turn = {"run": label, "seconds": time.perf_counter() - t0, "loss": loss}
        if sim is defended and sim._tail_events is not None:
            turn["security_ms"] = sim._tail_events[0].elapsed_time(sim._tail_events[1])
            sim._tail_events = None
        turns.append(turn)
    fedavg_s = statistics.mean(t["seconds"] for t in turns if t["run"] == "FedAvg")
    krum_s = statistics.mean(t["seconds"] for t in turns if t["run"] == "krum")
    log(f"  one cohort ({int(counts.sum())} samples), in turns: " + ", ".join(
        f"{t['run']} {t['seconds']:.4f} s" + (f" (tail {t['security_ms']:.2f} ms)"
                                             if "security_ms" in t else "") for t in turns)
        + f"; byzantine + krum over FedAvg {krum_s / fedavg_s:.4f}")
    del fedavg, defended, sims
    log("== phase 11b: every stacked defense and attack on one round's stack, card vs CPU")
    rules = trust_rules_phase(captured)
    return {"fedavg_peak_bytes": fedavg_peak, "runs": runs, "turns": turns,
            "krum_over_fedavg": krum_s / fedavg_s, "flash_launches": launches, "rules": rules}


def trust_rules_phase(captured):
    """Phase 11b: the captured round's [32, 855,770] fp32 stack through every
    stacked defense (tree mode; rows mode too where a rows-mode strategy
    would read it) and attack, on the card and on the CPU with the same
    draws; each card call timed (CUDA events, median of 5)."""
    import types

    import torch

    from fedml_tpu_torch.core.security import stacked as S
    from fedml_tpu_torch.models.convert import FlatLayout
    from fedml_tpu_torch.utils.rng import seeded_generator

    card = captured["mat"].device
    cpu = torch.device("cpu")
    mats = {card: captured["mat"], cpu: captured["mat"].cpu()}
    ws = {d: torch.from_numpy(captured["w"]).to(d) for d in (card, cpu)}
    mals = {d: torch.from_numpy(captured["mal"]).to(d) for d in (card, cpu)}
    gvars = {d: {k: v.to(d) for k, v in captured["variables"].items()} for d in (card, cpu)}
    layout = FlatLayout.of(gvars[cpu])
    gvecs = {d: layout.ravel(gvars[d]) for d in (card, cpu)}
    n, dim = mats[cpu].shape
    log(f"  captured stack [{n}, {dim}] fp32 ({n * dim * 4 / 1e6:.1f} MB), "
        f"{int(captured['mal'].sum())} malicious rows")

    def timed(fn):
        fn()
        per = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            per.append(start.elapsed_time(end))
        return statistics.median(per)

    out = {}
    for name, extra in TRUST_DEFENSES:
        args = types.SimpleNamespace(**{**TRUST_BASE, **extra})
        defense = S.build_stacked_defense(args, name)
        noise = defense.draw(n, dim, seeded_generator((0, 11), cpu), cpu)
        state = S.init_defense_state(name, n, dim, cpu)
        if name == "wbc":  # a previous round's rows, so the noise applies
            state = {"wbc_prev": mats[cpu] + 1e-4 * torch.randn(
                n, dim, generator=torch.Generator().manual_seed(5)), "wbc_has": torch.ones(())}
        res, t_cpu = {}, {}
        for d in (cpu, card):
            st = {k: v.to(d) for k, v in state.items()}
            nz = None if noise is None else noise.to(d)
            t0 = time.perf_counter()
            res[d] = defense.rows_fn(mats[d], ws[d], gvecs[d], None, st, nz, layout=layout)
            if d == card:
                torch.cuda.synchronize()
            t_cpu[d] = time.perf_counter() - t0
        want, selection, errs = res[cpu], None, {}
        if name in ("krum", "multi_krum", "bulyan"):
            want, selection = _forced_selection(name, defense, mats, ws, res, card, cpu)
        if name == "foolsgold":
            errs["weights"] = check_close(f"11b {name} weights", res[card][1].cpu(), want[1],
                                          TRUST_FOOLSGOLD_WEIGHT_TOL)
            want = (want[0], res[card][1].cpu(), want[2])
        for i, what in enumerate(("rows", "weights")):
            if what not in errs:
                errs[what] = check_close(f"11b {name} {what}", res[card][i].cpu(), want[i],
                                         TRUST_TOL)
        agg = S._wmean(res[card][0], res[card][1]).cpu()
        errs["aggregate"] = check_close(f"11b {name} aggregate", agg,
                                        S._wmean(want[0], want[1]), TRUST_TOL)
        st_card = {k: v.to(card) for k, v in state.items()}
        nz_card = None if noise is None else noise.to(card)
        ms = timed(lambda: defense.rows_fn(mats[card], ws[card], gvecs[card], None, st_card,
                                           nz_card, layout=layout))
        out[f"defense/{name}"] = {"ms": ms, "cpu_s": t_cpu[cpu], "max_abs_err": {
            k: e[0] for k, e in errs.items()}, "least_atol": {k: e[1] for k, e in errs.items()},
            "selection": selection}
        log(f"    {name:30s} card {ms:8.3f} ms, CPU {t_cpu[cpu]:7.3f} s; max |card - CPU| "
            + ", ".join(f"{k} {e[0]:.2e}" for k, e in errs.items())
            + (f"; selection {json.dumps(selection)}" if selection else ""))
    gen = seeded_generator((0, 12), cpu)
    for name, extra in TRUST_ATTACKS:
        args = types.SimpleNamespace(**extra)
        attack = S.build_stacked_attack(args, name)
        noise = attack.draw((n, dim), gen, cpu)
        res = {}
        for d in (cpu, card):
            res[d] = attack(mats[d], ws[d], gvecs[d], mals[d],
                            noise=None if noise is None else noise.to(d))
        err = check_close(f"11b {name} {extra}", res[card].cpu(), res[cpu], TRUST_TOL)
        nz_card = None if noise is None else noise.to(card)
        ms = timed(lambda: attack(mats[card], ws[card], gvecs[card], mals[card], noise=nz_card))
        label = f"attack/{name}" + (f"/{extra['attack_mode']}" if extra else "")
        out[label] = {"ms": ms, "max_abs_err": err[0], "least_atol": err[1]}
        log(f"    {label:37s} card {ms:8.3f} ms; max |card - CPU| {err[0]:.2e}")
    return out


def _forced_selection(name, defense, mats, ws, res, card, cpu):
    """krum's scores on both sides held to the Gram form's roundoff; the
    CPU's result of the rule on the card's selection (its own where the two
    pick the same rows), and what the selections were."""
    from fedml_tpu_torch.core.security import defense_funcs as F

    n = mats[cpu].shape[0]
    byz = defense.byz
    k = max(n - byz - 2, 1)
    scores = {d: F.krum_scores(mats[d], byz).cpu() for d in (cpu, card)}
    sq_max = float((mats[cpu].double() ** 2).sum(1).max())
    tol = TRUST_SCORE_RTOL * k * sq_max
    err = float((scores[card] - scores[cpu]).abs().max())
    if err > tol:
        raise AssertionError(f"11b {name}: krum scores differ by {err:.3e} > {tol:.3e}")
    m = min(n, {"krum": 1, "multi_krum": defense.krum_m, "bulyan": max(n - 2 * byz, 1)}[name])
    pick = {d: F.argsort(scores[d])[:m] for d in (cpu, card)}
    best = float(scores[cpu].sort().values[m - 1])
    worst_pick = float(scores[cpu][pick[card]].max())
    if worst_pick > best + tol:
        raise AssertionError(f"11b {name}: the card picked a row scoring {worst_pick:.6e} on the "
                             f"CPU, over the CPU's {m}-th best {best:.6e} + {tol:.3e}")
    same = sorted(pick[card].tolist()) == sorted(pick[cpu].tolist())
    same_order = pick[card].tolist() == pick[cpu].tolist()
    selection = {"same": same, "same_order": same_order, "score_err": err, "score_tol": tol,
                 "score_err_over_k_sq_max": err / (k * sq_max),
                 "card": sorted(pick[card].tolist()), "cpu": sorted(pick[cpu].tolist())}
    # bulyan's trim breaks exact ties in |x - median| (values on one ulp grid
    # sit symmetric about the median) by the rows' order in the selection,
    # which is the scores' order: two near-equal scores swapped by roundoff
    # pick the same rows in another order, and another of two values at one
    # distance.  So bulyan is held to the CPU on the card's ordered selection.
    if same_order or (same and name != "bulyan"):
        return res[cpu], selection
    mat = mats[cpu]
    if name == "bulyan":
        agg = F.bulyan_trim(mat[pick[card]], byz, m)
        return (agg[None, :].expand(mat.shape), ws[cpu], {}), selection
    sel = ws[cpu].new_zeros(n)
    sel[pick[card]] = 1.0
    return (mat, ws[cpu] * sel, {}), selection


def trust_hooks_phase(ft, fa):
    """Phase 11c: slice 1's TransformerLM, TRUST_HOOKS_ROUNDS rounds with
    krum and local DP, no eval: the security tail and the noise around rounds that launch K1-K3
    (fp32).  The counts are set to 0 before and read after."""
    import copy

    import torch

    config = copy.deepcopy(SLICE_CONFIG)
    config["train_args"].update(comm_round=TRUST_HOOKS_ROUNDS, enable_defense=True,
                                defense_type="krum",
                                byzantine_client_num=1, enable_dp=True, dp_type="ldp",
                                mechanism_type="gaussian", epsilon=50.0, sensitivity=0.01)
    config["validation_args"]["frequency_of_the_test"] = 0
    args = ft.init(ft.Arguments.from_dict(copy.deepcopy(config)), should_init_logs=False)
    dataset, classes = ft.data.load(args)
    fa.reset_launches()
    runner = ft.FedMLRunner(args, ft.device.get_device(args), dataset,
                            ft.models.hub.create(args, classes))
    sim = runner.runner.sim
    runner.run()
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    if not all(math.isfinite(x) for x in sim.round_losses) or not all(
            bool(torch.isfinite(v).all()) for v in sim.variables.values()):
        raise AssertionError(f"krum + LDP on slice 1: losses {sim.round_losses}")
    for name in SLICE1_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched under the trust path")
    if any(launches[name] for name in launches if name not in SLICE1_KERNELS):
        raise AssertionError(f"a bf16 kernel or the ring's fold launched: {launches}")
    out = {"round_seconds": list(sim.round_times), "losses": list(sim.round_losses),
           "security_ms": list(sim.security_ms), "launches": launches}
    log(f"  krum + LDP on slice 1: rounds {[round(t, 4) for t in sim.round_times]} s, tail "
        f"{[round(t, 3) for t in sim.security_ms]} ms, losses "
        f"{[round(x, 6) for x in sim.round_losses]}; launches {launches}")
    return launches, out


# phase 12: the sp backend (FedAvgAPI).  12a: the port's default config
# through a bare run_simulation(), its 200 rounds cut to SP_BACKEND_DEFAULT_ROUNDS,
# then the sp FedAvg example configs; 12b: BENCH_CONFIG on sp; 12c: slice 1's
# configuration on sp
SP_BACKEND_DEFAULT_ROUNDS = 5
SP_BACKEND_EXAMPLES = ("sp_fedavg_mnist_lr", "sp_fedavg_robust_mnist_lr", "sp_fedavg_cdp_mnist_lr",
               "sp_fedavg_ldp_mnist_lr")
SP_BACKEND_ROUNDS = 2
# 12b: BENCH_CONFIG on sp with its cohort cut to this many clients (16
# until phase 17 was added)
SP_BACKEND_COHORT = 8
# card against CPU, final params of a deterministic sp run of lr: the two sum
# each product in another order (TF32 off), through a few rounds of SGD
SP_BACKEND_CPU_ATOL = 1e-4


def _tf32_flags():
    import torch

    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def _sp_backend_run(ft, config, dataset=None, classes=None):
    """An sp run through the entry points: (final eval, the FedAvgAPI).  The
    TF32 flags must be the same before and after it."""
    import copy

    args = ft.init(ft.Arguments.from_dict(copy.deepcopy(config)), should_init_logs=False)
    device = ft.device.get_device(args)
    if dataset is None:
        dataset, classes = ft.data.load(args)
    runner = ft.FedMLRunner(args, device, dataset, ft.models.hub.create(args, classes))
    flags = _tf32_flags()
    final = runner.run()
    if _tf32_flags() != flags:
        raise AssertionError(f"an sp run changed the TF32 flags: {flags} -> {_tf32_flags()}")
    return final, runner.runner.fl_trainer


def _max_param_diff(a, b) -> float:
    return max((a[k].float().cpu() - b[k].float().cpu()).abs().max().item() for k in a)


def _finite(api) -> bool:
    import torch

    return all(bool(torch.isfinite(v).all()) for v in api.w_global.values())


def sp_backend_default_phase(ft, fa):
    """12a: a bare ``run_simulation()`` (sys.argv stubbed, no --cf) on the
    card, then on the CPU, from the port's default config; then the sp FedAvg
    example configs, card against CPU where the run is deterministic."""
    import copy

    import yaml
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy

    out = {}
    runners = []
    load, runner_cls = ft.load_arguments, ft.FedMLRunner

    class Recorded(runner_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runners.append(self)

    def run_default(device_type):
        def cut(*a, **k):
            args = load(*a, **k)
            log(f"  {args.yaml_config_file}: comm_round {args.comm_round} cut to "
                f"{SP_BACKEND_DEFAULT_ROUNDS}" + (f", device_type {device_type}" if device_type else ""))
            args.comm_round = SP_BACKEND_DEFAULT_ROUNDS
            args.log_file_dir = os.path.join(OUT_DIR, "log")
            if device_type:
                args.device_type = device_type
            return args

        argv = sys.argv
        sys.argv = [argv[0]]
        ft.load_arguments, ft.FedMLRunner = cut, Recorded
        try:
            t0 = time.perf_counter()
            final = ft.run_simulation()
            return final, runners[-1].runner.fl_trainer, time.perf_counter() - t0
        finally:
            sys.argv = argv
            ft.load_arguments, ft.FedMLRunner = load, runner_cls

    fa.reset_launches()
    flags = _tf32_flags()
    final, api, seconds = run_default(None)
    if _tf32_flags() != flags:
        raise AssertionError(f"run_simulation changed the TF32 flags: {flags} -> {_tf32_flags()}")
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"a flash kernel launched on the lr path: {fa.LAUNCHES}")
    if str(api.args.backend) != "sp" or not _finite(api):
        raise AssertionError(f"default run: backend {api.args.backend}, final {final}")
    cpu_final, cpu_api, cpu_seconds = run_default("cpu")
    diff = _max_param_diff(api.w_global, cpu_api.w_global)
    log(f"  default config ({api.args.dataset} {api.args.model}, {api.args.client_num_in_total} "
        f"clients, {api.args.client_num_per_round} a round) on {api.device}: {final} in "
        f"{seconds:.2f} s "
        f"(rounds {[round(t, 4) for t in api.round_times]} s), CPU {cpu_final} in "
        f"{cpu_seconds:.2f} s; max |param diff| {diff:.3e} (atol {SP_BACKEND_CPU_ATOL})")
    if diff > SP_BACKEND_CPU_ATOL:
        raise AssertionError(f"default config: card vs CPU params differ by {diff:.3e}")
    out["default"] = {"final": final, "cpu_final": cpu_final, "seconds": seconds,
                      "round_seconds": list(api.round_times), "max_param_diff": diff}

    for name in SP_BACKEND_EXAMPLES:
        with open(os.path.join(ROOT, "examples", "simulation", name, "fedml_config.yaml")) as f:
            config = yaml.safe_load(f)
        config["tracking_args"]["log_file_dir"] = os.path.join(OUT_DIR, "log")
        runs = [("card", config)]
        attack = config.get("attack_args", {})
        if attack.get("attack_mode") == "random":
            zero = copy.deepcopy(config)
            zero["attack_args"]["attack_mode"] = "zero"
            runs.append(("card, zero attack", zero))
        for label, cfg in runs:
            t0 = time.perf_counter()
            final, api = _sp_backend_run(ft, cfg)
            seconds = time.perf_counter() - t0
            dp = FedMLDifferentialPrivacy.get_instance()
            spends = len(dp.accountant) if dp.is_dp_enabled else 0
            dp_type = dp.dp_type if dp.is_dp_enabled else None
            entry = {"final": final, "seconds": seconds, "round_seconds": list(api.round_times),
                     "dp_type": dp_type, "dp_spends": spends}
            if not _finite(api) or "test_acc" not in final:
                raise AssertionError(f"{name} ({label}): {final} on {api.device}")
            deterministic = not dp_type and cfg.get("attack_args", {}).get("attack_mode") != "random"
            if deterministic:
                cpu_cfg = copy.deepcopy(cfg)
                cpu_cfg["device_args"] = {"device_type": "cpu"}
                cpu_final, cpu_api = _sp_backend_run(ft, cpu_cfg)
                entry["cpu_final"] = cpu_final
                entry["max_param_diff"] = _max_param_diff(api.w_global, cpu_api.w_global)
                if entry["max_param_diff"] > SP_BACKEND_CPU_ATOL:
                    raise AssertionError(f"{name} ({label}): card vs CPU params differ by "
                                         f"{entry['max_param_diff']:.3e}")
            out[f"{name} ({label})"] = entry
            log(f"  {name} ({label}): {final} in {seconds:.2f} s; dp {dp_type} spends {spends}"
                + (f"; CPU {entry['cpu_final']}, max |param diff| "
                   f"{entry['max_param_diff']:.3e}" if deterministic else ""))
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"a flash kernel launched on the lr path: {fa.LAUNCHES}")
    return out


def sp_backend_resnet_phase(ft, fa, dataset, classes, packed):
    """12b: BENCH_CONFIG on the sp backend (each client through the trainer's
    padded engine, no packing) with a cohort of SP_BACKEND_COHORT, 2 rounds,
    on phase 8's dataset, round 0 under torch.profiler for the card's busy
    share: round seconds and
    samples/s beside phase 8's packed round, each client's bucket and real
    steps, peak memory, no flash launch; then round 1's cohort in turns
    with the packed round on it."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile

    config = copy.deepcopy(BENCH_CONFIG)
    config["train_args"].update(comm_round=SP_BACKEND_ROUNDS, xla_pack=False,
                                client_num_per_round=SP_BACKEND_COHORT)
    config["validation_args"]["frequency_of_the_test"] = SP_BACKEND_ROUNDS
    config["comm_args"]["backend"] = "sp"
    args = ft.init(ft.Arguments.from_dict(copy.deepcopy(config)), should_init_logs=False)
    runner = ft.FedMLRunner(args, ft.device.get_device(args), dataset,
                            ft.models.hub.create(args, classes))
    api = runner.runner.fl_trainer
    clients = []
    train = api.trainer.train

    def recorded(train_data, device, a, extra=None):
        result = train(train_data, device, a, extra)
        n = len(train_data[1])
        clients.append({"round": api.trainer.round_idx, "client": int(api.trainer.id), "n": n,
                        "bucket": api.trainer.padded_size(n, int(a.batch_size)),
                        "steps": int(result.steps)})
        return result

    api.trainer.train = recorded
    # round 0 runs under torch.profiler, from its cohort's draw to the end of
    # its server step; device activity only: recording every aten op would
    # slow the host, which binds the round.  Round 1 runs unprofiled.
    prof = profile(activities=[ProfilerActivity.CUDA])
    window = {}
    sample, update = api._client_sampling, api.server_update

    def sampling(round_idx):
        if round_idx == 0:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        return sample(round_idx)

    def server_update(w_locals):
        out = update(w_locals)
        if "t0" in window and "wall_ms" not in window:
            torch.cuda.synchronize()
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
            prof.stop()
        return out

    api._client_sampling, api.server_update = sampling, server_update
    fa.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # earlier phases' live tensors stay in the peak: the run's own share is
    # the peak over what was allocated when it started
    base = torch.cuda.memory_allocated()
    final = runner.run()
    peak = torch.cuda.max_memory_allocated()
    api.trainer.train, api._client_sampling, api.server_update = train, sample, update
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"a flash kernel launched on the sp ResNet path: {fa.LAUNCHES}")
    if not _finite(api) or not math.isfinite(final["test_loss"]):
        raise AssertionError(f"sp ResNet-56: {final}")
    rounds = []
    for r, (dt, samples) in enumerate(zip(api.round_times, api.samples_per_round)):
        mine = [c for c in clients if c["round"] == r]
        rounds.append({"round": r, "seconds": dt, "samples": samples,
                       "samples_per_s": samples / dt,
                       "steps": sum(c["steps"] for c in mine),
                       "packed_steps": sum(-(-c["n"] // int(args.batch_size)) for c in mine)})
        log(f"  round {r}{' (under the profiler)' if r == 0 else ''}: {dt:.4f} s, {samples} "
            f"samples ({samples / dt:,.1f} samples/s), "
            f"{rounds[-1]['steps']} steps (the packed round would take "
            f"{rounds[-1]['packed_steps']}); clients (n, bucket, steps): "
            + ", ".join(f"{c['client']} ({c['n']}, {c['bucket']}, {c['steps']})" for c in mine))
    log(f"  beside phase 8's packed round: sp round 1 {api.round_times[-1]:.4f} s, "
        f"{rounds[-1]['samples_per_s']:,.1f} samples/s; packed median "
        f"{packed['median_round_s']:.4f} s, {packed['samples_per_sec']:,.1f} samples/s; "
        f"peak memory {peak / 2**30:.3f} GiB, {(peak - base) / 2**30:.3f} GiB over the "
        f"{base / 2**30:.3f} GiB allocated at the start; final eval {final}")

    # round 1's cohort in turns (packed, sp, packed): the packed round of
    # phase 8's simulator, built again on this dataset, and the sp round; the
    # host's speed drifts within a call, so the ratio is taken in turns
    pconfig = copy.deepcopy(BENCH_CONFIG)
    pconfig["train_args"]["client_num_per_round"] = SP_BACKEND_COHORT
    pargs = ft.init(ft.Arguments.from_dict(pconfig), should_init_logs=False)
    psim = ft.FedMLRunner(pargs, ft.device.get_device(pargs), dataset,
                          ft.models.hub.create(pargs, classes)).runner.sim
    pids, real = psim._schedule(psim._client_sampling(1))
    pcounts = np.where(real > 0, psim.client_counts[pids], 0)
    ids = api._client_sampling(1)
    turns = []
    for kind in ("packed", "sp", "packed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ft.device.fp32_matmul():
            if kind == "packed":
                float(psim._run_packed_round(1, pids, pcounts))
            else:
                api.server_update(api._local_updates(1, ids))
        torch.cuda.synchronize()
        turns.append({"kind": kind, "seconds": time.perf_counter() - t0})
    del psim
    sp_over_packed = (statistics.median(t["seconds"] for t in turns if t["kind"] == "sp")
                      / statistics.median(t["seconds"] for t in turns if t["kind"] == "packed"))
    log("  round 1's cohort in turns: " + ", ".join(
        f"{t['kind']} {t['seconds']:.4f} s" for t in turns)
        + f"; sp over packed {sp_over_packed:.3f}")

    device_ms = 0.0
    families: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ms = e.duration_ns() / 1e6
            device_ms += ms
            families[kernel_family(e.name())] = families.get(kernel_family(e.name()), 0.0) + ms
    wall_ms = window["wall_ms"]
    log(f"  round 0 under the profiler: wall {wall_ms:.1f} ms, device busy {device_ms:.1f} ms "
        f"({100 * device_ms / wall_ms:.1f} %; {100 * device_ms / 1e3 / api.round_times[1]:.1f} "
        f"% of round 1's unprofiled seconds); by family "
        + json.dumps({k: round(v, 3) for k, v in sorted(families.items())}))
    return {"rounds": rounds, "clients": clients, "final": final, "peak_memory_bytes": peak,
            "allocated_at_start_bytes": base, "turns": turns, "sp_over_packed": sp_over_packed,
            "packed": {"median_round_s": packed["median_round_s"],
                       "samples_per_sec": packed["samples_per_sec"]},
            "profile": {"wall_ms": wall_ms, "device_ms": device_ms, "families_ms": families}}


def sp_backend_transformer_phase(ft, fa):
    """12c: slice 1's configuration (hub TransformerLM, shakespeare) on the
    sp backend, 2 rounds with an eval each: K1-K3 (fp32) launch in every
    step and eval forward.  The counts are set to 0 just before the run and
    read just after, and must equal the layers times the trainer's recorded
    steps (K2, K3), plus the eval forwards' (K1)."""
    import copy

    import torch

    config = copy.deepcopy(SLICE_CONFIG)
    config["train_args"]["comm_round"] = SP_BACKEND_ROUNDS
    config["comm_args"]["backend"] = "sp"
    args = ft.init(ft.Arguments.from_dict(copy.deepcopy(config)), should_init_logs=False)
    dataset, classes = ft.data.load(args)
    model = ft.models.hub.create(args, classes)
    runner = ft.FedMLRunner(args, ft.device.get_device(args), dataset, model)
    api = runner.runner.fl_trainer
    steps = []
    train = api.trainer.train

    def recorded(train_data, device, a, extra=None):
        result = train(train_data, device, a, extra)
        steps.append(int(result.steps))
        return result

    api.trainer.train = recorded
    fa.reset_launches()
    final = runner.run()
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    layers = model.cfg.n_layers
    eval_fwd = SP_BACKEND_ROUNDS * -(-dataset[1] // int(getattr(args, "eval_batch_size", 256))) * layers
    want = dict.fromkeys(launches, 0)
    want.update(flash_bwd_dq=layers * sum(steps), flash_bwd_dkv=layers * sum(steps),
                flash_fwd=layers * sum(steps) + eval_fwd)
    log(f"  sp TransformerLM: rounds {[round(t, 4) for t in api.round_times]} s, "
        f"{len(steps)} client runs of {sum(steps)} steps, {layers} layers; final eval {final}; "
        f"launches {launches}, predicted {want}")
    if launches != want:
        raise AssertionError(f"sp TransformerLM launches {launches}, predicted {want}")
    if not _finite(api) or not math.isfinite(final["test_loss"]):
        raise AssertionError(f"sp TransformerLM: {final}")
    return launches, {"round_seconds": list(api.round_times),
                      "samples_per_round": list(api.samples_per_round), "steps": steps,
                      "final": final, "launches": launches, "predicted": want}


# phase 13: the rest of the sp zoo.  13a: the zoo's example configs (and
# FedBuff and AsyncFedAvg on sp_fedavg_mnist_lr) card against CPU, then
# FedBuff against FedAvgAPI in FedBuff's equivalence configuration; 13b:
# each member on BENCH_CONFIG at a cohort of 4 for 2 rounds; 13c: SCAFFOLD
# and FedSGD on slice 1's configuration under the flash kernels
SP_ZOO_EXAMPLES = (
    ("sp_fedopt_mnist_lr", None), ("sp_fedprox_mnist_lr", None), ("sp_fednova_mnist_lr", None),
    ("sp_fedsgd_mnist_lr", None), ("sp_scaffold_mnist_lr", None), ("sp_feddyn_mnist_lr", None),
    ("sp_hierarchical_fl_mnist_lr", None), ("sp_decentralized_mnist_lr", None),
    ("sp_turbo_aggregate_mnist_lr", None),
    ("sp_fedavg_mnist_lr", {"fl_mode": "async"}),
    ("sp_fedavg_mnist_lr", {"federated_optimizer": "Async_FedAvg"}),
)
# 13b: BENCH_CONFIG on sp with a cohort of 4, 2 rounds (AsyncFedAvg: 8
# updates; FedBuff: 4 flushes of 2), only the member's knobs changed; the
# depth is cut to keep the whole script near half its time limit
SP_ZOO_COHORT = 4
SP_ZOO = [
    ("FedAvg", {}),
    ("FedProx", {"federated_optimizer": "FedProx", "proximal_mu": 0.01}),
    ("FedOpt", {"federated_optimizer": "FedOpt", "server_optimizer": "adam", "server_lr": 0.01}),
    ("FedNova", {"federated_optimizer": "FedNova"}),
    ("FedSGD", {"federated_optimizer": "FedSGD"}),
    ("SCAFFOLD", {"federated_optimizer": "SCAFFOLD"}),
    ("FedDyn", {"federated_optimizer": "FedDyn", "feddyn_alpha": 0.01}),
    ("AsyncFedAvg", {"federated_optimizer": "Async_FedAvg", "comm_round": 8}),
    ("FedBuff", {"fl_mode": "async", "async_buffer_size": 2, "async_max_staleness": 2,
                 "async_staleness_policy": "polynomial", "comm_round": 4}),
    ("HierarchicalFL", {"federated_optimizer": "HierarchicalFL", "group_num": 2,
                        "group_comm_round": 2}),
    # every node trains every round: 8 nodes, the data partitioned again at
    # that count and cut to 4,000 images (about the 500 a client of the others)
    ("decentralized", {"federated_optimizer": "decentralized_fl", "client_num_in_total": 8,
                       "synthetic_train_size": 4000}),
    ("TurboAggregate", {"federated_optimizer": "turbo_aggregate", "ta_group_num": 4}),
]


def sp_zoo_examples_phase(ft, fa):
    """13a: the zoo's example configs, FedBuff and AsyncFedAvg on
    sp_fedavg_mnist_lr, on the card and on the CPU (every run is
    deterministic: Turbo-Aggregate's masks come from a CPU generator); then
    FedBuff in its equivalence configuration against FedAvgAPI on the card."""
    import copy

    import torch
    import yaml

    out = {}
    fa.reset_launches()
    for name, knobs in SP_ZOO_EXAMPLES:
        with open(os.path.join(ROOT, "examples", "simulation", name, "fedml_config.yaml")) as f:
            config = yaml.safe_load(f)
        config["tracking_args"]["log_file_dir"] = os.path.join(OUT_DIR, "log")
        config["train_args"].update(knobs or {})
        label = name + (f" {knobs}" if knobs else "")
        t0 = time.perf_counter()
        final, api = _sp_backend_run(ft, config)
        seconds = time.perf_counter() - t0
        cpu_cfg = copy.deepcopy(config)
        cpu_cfg["device_args"] = {"device_type": "cpu"}
        cpu_final, cpu_api = _sp_backend_run(ft, cpu_cfg)
        diff = _max_param_diff(api.w_global, cpu_api.w_global)
        out[label] = {"member": type(api).__name__, "final": final, "cpu_final": cpu_final,
                      "seconds": seconds, "round_seconds": list(api.round_times),
                      "max_param_diff": diff}
        log(f"  {label}: {type(api).__name__} on {api.device}: {final} in {seconds:.2f} s; CPU "
            f"{cpu_final}; max |param diff| {diff:.3e} (atol {SP_BACKEND_CPU_ATOL})")
        if not _finite(api) or "test_acc" not in final:
            raise AssertionError(f"{label}: {final} on {api.device}")
        if diff > SP_BACKEND_CPU_ATOL:
            raise AssertionError(f"{label}: card vs CPU params differ by {diff:.3e}")

    # FedBuff's equivalence: full participation, a buffer of the cohort,
    # staleness 0, the constant policy: the sync FedAvg loop, bit for bit
    with open(os.path.join(ROOT, "examples", "simulation", "sp_fedavg_mnist_lr",
                           "fedml_config.yaml")) as f:
        sync = yaml.safe_load(f)
    sync["tracking_args"]["log_file_dir"] = os.path.join(OUT_DIR, "log")
    n = int(sync["train_args"]["client_num_in_total"])
    sync["train_args"]["client_num_per_round"] = n
    fedbuff = copy.deepcopy(sync)
    fedbuff["train_args"].update(fl_mode="async", async_buffer_size=n, async_max_staleness=0,
                                 async_staleness_policy="constant")
    _, sapi = _sp_backend_run(ft, sync)
    _, bapi = _sp_backend_run(ft, fedbuff)
    diff = _max_param_diff(bapi.w_global, sapi.w_global)
    bitwise = all(torch.equal(bapi.w_global[k], sapi.w_global[k]) for k in sapi.w_global)
    log(f"  FedBuff ({type(bapi).__name__}, {n} of {n}, buffer {n}, staleness 0, constant) "
        f"against FedAvgAPI on the card: max |param diff| {diff:.3e}, bitwise {bitwise}, "
        f"flushes {[f['senders'] for f in bapi.flush_log]}")
    if not bitwise:
        if diff > 1e-6:
            raise AssertionError(f"FedBuff's equivalence: params differ by {diff:.3e}")
        log("  not bitwise: within 1e-6, the two fold the same updates in the same order, so "
            "the difference is the card's reduction order inside an op")
    out["fedbuff_equivalence"] = {"max_param_diff": diff, "bitwise": bitwise,
                                  "flushes": [f["senders"] for f in bapi.flush_log]}
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"a flash kernel launched on the lr path: {fa.LAUNCHES}")
    return out


def _sp_zoo_invariant(name, api, steps) -> dict:
    """The member's own invariant after its run (13b)."""
    import torch

    if name == "SCAFFOLD":
        # c = (1/N) sum_i c_i, up to the fp32 sums that build each
        n = float(api.args.client_num_in_total)
        err = scale = 0.0
        for k, c in api.c_server.items():
            total = sum(ci[k].double() for ci in api.c_clients.values()) / n
            err = max(err, (c.double() - total).abs().max().item())
            scale = max(scale, max(ci[k].abs().max().item() for ci in api.c_clients.values()))
        if not err <= ZOO_MEAN_RTOL * scale:
            raise AssertionError(f"SCAFFOLD: max |c - mean c_i| {err:.3e} > "
                                 f"{ZOO_MEAN_RTOL} * {scale:.3e}")
        return {"clients_seen": len(api.c_clients), "max_abs_diff": err,
                "table_max_abs": scale}
    if name == "FedDyn":
        # h = sum over every client seen of h_i / client_num_in_total, in the
        # server's order: bit for bit
        hs = list(api.h_clients.values())
        n = float(api.args.client_num_in_total)
        same = all(torch.equal(api.h_mean[k], sum(h[k] for h in hs) / n) for k in api.h_mean)
        if not same:
            raise AssertionError("FedDyn: h is not the sum of the h_i over the population")
        return {"clients_seen": len(hs), "h_norm": _norm(api.h_mean)}
    if name == "FedNova":
        last = steps[-len(api._round_taus):]
        if api._round_taus != [float(s) for s in last]:
            raise AssertionError(f"FedNova: taus {api._round_taus}, trainer steps {last}")
        return {"taus": list(api._round_taus)}
    if name == "FedBuff":
        flushes = api.flush_log
        if (len(flushes) != int(api.args.comm_round)
                or any(f["n_deltas"] != api.buffer.capacity for f in flushes)
                or any(s > api.max_staleness for f in flushes for s in f["staleness"])):
            raise AssertionError(f"FedBuff's flushes: {flushes}")
        return {"flushes": [{k: f[k] for k in ("senders", "staleness", "dropped_stale",
                                               "dropped_dup")}
                            for f in flushes]}
    if name == "HierarchicalFL":
        sizes = [len(g) for g in api.groups]
        want = [len(g) for g in np.array_split(np.arange(int(api.args.client_num_in_total)),
                                               api.group_num)]
        chosen = [[len(g) for g in r] for r in api.chosen]
        per_group = SP_ZOO_COHORT // api.group_num
        if sizes != want or any(c != [per_group] * api.group_num for c in chosen):
            raise AssertionError(f"HierarchicalFL: group sizes {sizes}, chosen {chosen}")
        return {"group_sizes": sizes, "chosen_per_group": chosen}
    if name == "decentralized":
        same = all(torch.equal(v, torch.stack([m[k] for m in api.node_models]).mean(dim=0))
                   for k, v in api.w_global.items())
        if not same:
            raise AssertionError("decentralized: the consensus is not the mean of the nodes")
        return {"nodes": len(api.node_models), "topology_degree": [
            int((row > 0).sum()) for row in api.topo.topology]}
    return {}


def sp_zoo_resnet_phase(ft, fa, dataset, classes):
    """13b: each member on BENCH_CONFIG (ResNet-56) on sp, a cohort of 4 for
    2 rounds, on phase 8's dataset (decentralized: 8 nodes on its own):
    round seconds, finite params, the member's invariant, peak memory over
    FedAvg's run on the same cohort, no flash launch."""
    import copy

    import torch

    base = copy.deepcopy(BENCH_CONFIG)
    base["train_args"].update(xla_pack=False, client_num_per_round=SP_ZOO_COHORT, comm_round=2)
    base["comm_args"]["backend"] = "sp"
    out = {}
    for name, knobs in SP_ZOO:
        config = copy.deepcopy(base)
        knobs = dict(knobs)
        own_data = "synthetic_train_size" in knobs
        if own_data:
            config["data_args"]["synthetic_train_size"] = knobs.pop("synthetic_train_size")
        config["train_args"].update(knobs)
        # an eval at round 0 and after the last round
        config["validation_args"]["frequency_of_the_test"] = int(config["train_args"]["comm_round"])
        args = ft.init(ft.Arguments.from_dict(copy.deepcopy(config)), should_init_logs=False)
        data, cls = ft.data.load(args) if own_data else (dataset, classes)
        runner = ft.FedMLRunner(args, ft.device.get_device(args), data,
                                ft.models.hub.create(args, cls))
        api = runner.runner.fl_trainer
        steps = []
        train = api.trainer.train

        def recorded(train_data, device, a, extra=None, _train=train):
            result = _train(train_data, device, a, extra)
            steps.append(int(result.steps))
            return result

        api.trainer.train = recorded
        fa.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        allocated = torch.cuda.memory_allocated()
        flags = _tf32_flags()
        t0 = time.perf_counter()
        final = runner.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - allocated
        if _tf32_flags() != flags:
            raise AssertionError(f"{name} changed the TF32 flags: {flags} -> {_tf32_flags()}")
        if any(fa.LAUNCHES.values()):
            raise AssertionError(f"a flash kernel launched on the sp ResNet path: {fa.LAUNCHES}")
        if type(api).__name__ == "FedAvgAPI" and name != "FedAvg":
            raise AssertionError(f"{name} built FedAvgAPI")
        if not _finite(api) or not math.isfinite(final["test_loss"]):
            raise AssertionError(f"sp ResNet-56 {name}: {final}")
        entry = {"member": type(api).__name__, "seconds": seconds,
                 "round_seconds": list(api.round_times), "client_runs": len(steps),
                 "steps": sum(steps), "final": final, "peak_over_start_bytes": peak,
                 "invariant": _sp_zoo_invariant(name, api, steps)}
        if name != "FedAvg":
            entry["peak_over_fedavg_mib"] = (peak - out["FedAvg"]["peak_over_start_bytes"]) / 2**20
        out[name] = entry
        log(f"  {name} ({entry['member']}): {seconds:.2f} s, rounds "
            f"{[round(t, 3) for t in api.round_times]} s, {len(steps)} client runs of "
            f"{sum(steps)} steps; peak {peak / 2**30:.3f} GiB over the start"
            + (f" ({entry['peak_over_fedavg_mib']:+.1f} MiB over FedAvg's)"
               if name != "FedAvg" else "")
            + f"; final {final}; invariant {json.dumps(entry['invariant'])[:400]}")
        api.trainer.train = train
        del runner, api
    return out


def sp_zoo_transformer_phase(ft, fa):
    """13c: SCAFFOLD and FedSGD on slice 1's configuration (hub TransformerLM,
    shakespeare, fp32) on sp, 2 rounds with an eval each, the counts set to
    0 just before each run and read just after.  SCAFFOLD launches as 12c:
    K2 = K3 = layers x steps, K1 that plus layers x eval batches x evals;
    FedSGD's gradient is one forward and backward over each client's padded
    data: K1 = layers x (client gradients + eval batches x evals), K2 = K3 =
    layers x client gradients."""
    import copy

    import torch

    total = {}
    out = {}
    for name in ("SCAFFOLD", "FedSGD"):
        config = copy.deepcopy(SLICE_CONFIG)
        config["train_args"].update(comm_round=SP_BACKEND_ROUNDS, federated_optimizer=name)
        config["comm_args"]["backend"] = "sp"
        args = ft.init(ft.Arguments.from_dict(copy.deepcopy(config)), should_init_logs=False)
        dataset, classes = ft.data.load(args)
        model = ft.models.hub.create(args, classes)
        runner = ft.FedMLRunner(args, ft.device.get_device(args), dataset, model)
        api = runner.runner.fl_trainer
        runs = []  # SCAFFOLD: each client's steps; FedSGD: each gradient's bucket
        if name == "SCAFFOLD":
            train = api.trainer.train

            def recorded(train_data, device, a, extra=None):
                result = train(train_data, device, a, extra)
                runs.append(int(result.steps))
                return result

            api.trainer.train = recorded
        else:
            grad = api._train_client

            def recorded(client, w_global):
                n = len(client.local_training_data[1])
                runs.append(api.trainer.padded_size(n, int(api.args.batch_size)))
                return grad(client, w_global)

            api._train_client = recorded
        fa.reset_launches()
        t0 = time.perf_counter()
        final = runner.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        layers = model.cfg.n_layers
        evals = SP_BACKEND_ROUNDS * -(-dataset[1] // int(getattr(args, "eval_batch_size", 256)))
        backward = layers * (sum(runs) if name == "SCAFFOLD" else len(runs))
        want = dict.fromkeys(launches, 0)
        want.update(flash_bwd_dq=backward, flash_bwd_dkv=backward,
                    flash_fwd=backward + layers * evals)
        log(f"  sp TransformerLM {name} ({type(api).__name__}): {seconds:.2f} s, rounds "
            f"{[round(t, 4) for t in api.round_times]} s, "
            + (f"{len(runs)} client runs of {sum(runs)} steps" if name == "SCAFFOLD"
               else f"{len(runs)} client gradients, buckets {sorted(runs)}")
            + f", {layers} layers; final eval {final}; launches {launches}, predicted {want}")
        if launches != want:
            raise AssertionError(f"sp TransformerLM {name} launches {launches}, predicted {want}")
        if not _finite(api) or not math.isfinite(final["test_loss"]):
            raise AssertionError(f"sp TransformerLM {name}: {final}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        out[name] = {"seconds": seconds, "round_seconds": list(api.round_times), "runs": runs,
                     "final": final, "launches": launches, "predicted": want}
    return total, out


# phase 14: the FedNLP task family.  14a: the seq2seq example config as it
# stands (transformer_s2s, under K1-K3), then one short sp FedAvg of each
# dataset of the family at its hub width with the example's knobs but SGD,
# each again on the CPU; 14b: the example on the padded and the packed round
NLP_EXAMPLE = "sp_fedavg_s2s_transformer"
NLP_RUNS = (("synthetic_s2s", "transformer_s2s"), ("agnews", "transformer_cls"),
            ("onto_tagging", "transformer_tagger"), ("squad_span", "transformer_span"),
            ("stackoverflow_lr", "lr"))
NLP_SGD = {"client_optimizer": "sgd", "learning_rate": 0.1}
# 14b: the example's rounds raised from 2 to 3, so the median round after the
# first has two to take
NLP_XLA_ROUNDS = 3
# card against CPU, final params of an SGD run: TF32 off inside both (the
# kernels' products split TF32, about 21 bits an operand), sums in another
# order, through 2 rounds of 8 steps a client
NLP_CPU_ATOL = 1e-4
# the example's adam: its first steps move every coordinate by about lr in
# the sign of its gradient, so a coordinate whose gradient is at the
# roundoff level can step the other way on the card, and two runs that
# differ only in roundoff part by up to 2 lr a step, averaged over the
# clients.  On the CPU alone, the example's run with the reference attention
# in place of the kernels' plain versions (both fp32) ends 8.8e-3 from the
# default run (2.4e-7 with SGD at lr 0.1), and an "NVIDIA H100 80GB HBM3,
# 700.00 W" ended 5.4e-3 from the CPU; the bound is 2 lr.
NLP_ADAM_CPU_ATOL_OVER_LR = 2.0


def _nlp_example_config() -> dict:
    import yaml

    with open(os.path.join(ROOT, "examples", "simulation", NLP_EXAMPLE,
                           "fedml_config.yaml")) as f:
        config = yaml.safe_load(f)
    config["tracking_args"]["log_file_dir"] = os.path.join(OUT_DIR, "log")
    return config


def nlp_sp_phase(ft, fa):
    """14a: the seq2seq example config through the entry points on the card,
    then each dataset of the family (NLP_RUNS) with the example's knobs but
    SGD, every run again on the CPU (final params within the example's
    adam bound, NLP_CPU_ATOL for the SGD runs).  The counts are set to 0
    just before each card run and read just after: a seq2seq run launches
    K2 = K3 = layers x the trainer's recorded steps and K1 that plus layers
    x its evals (one forward over the test split each); the encoders and lr
    launch none.  Returns the example run's counts and the runs' records."""
    import copy

    import torch

    example = _nlp_example_config()
    runs = [(NLP_EXAMPLE, example, NLP_ADAM_CPU_ATOL_OVER_LR
             * float(example["train_args"]["learning_rate"]))]
    for dataset, model in NLP_RUNS:
        config = copy.deepcopy(example)
        config["data_args"]["dataset"] = dataset
        config["model_args"]["model"] = model
        config["train_args"].update(NLP_SGD)
        runs.append((f"{dataset} {model} (sgd)", config, NLP_CPU_ATOL))
    out, s2s_launches = {}, None
    for name, config, atol in runs:
        args = ft.init(ft.Arguments.from_dict(copy.deepcopy(config)), should_init_logs=False)
        dataset, classes = ft.data.load(args)
        model = ft.models.hub.create(args, classes)
        runner = ft.FedMLRunner(args, ft.device.get_device(args), dataset, model)
        api = runner.runner.fl_trainer
        steps, evals = [], []
        train, test = api.trainer.train, api._test_global

        def recorded(train_data, device, a, extra=None, _train=train):
            result = _train(train_data, device, a, extra)
            steps.append(int(result.steps))
            return result

        def tested(round_idx, _test=test):
            evals.append(round_idx)
            return _test(round_idx)

        api.trainer.train, api._test_global = recorded, tested
        flags = _tf32_flags()
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = runner.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        if _tf32_flags() != flags:
            raise AssertionError(f"{name}: the run changed the TF32 flags")
        if not _finite(api) or not math.isfinite(final["test_loss"]):
            raise AssertionError(f"{name}: {final}")
        want = dict.fromkeys(launches, 0)
        if args.model == "transformer_s2s":
            layers = model.cfg.n_layers
            want.update(flash_bwd_dq=layers * sum(steps), flash_bwd_dkv=layers * sum(steps),
                        flash_fwd=layers * (sum(steps) + len(evals)))
        if name == NLP_EXAMPLE:
            s2s_launches = launches
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, predicted {want}")
        cpu = copy.deepcopy(config)
        cpu["device_args"] = {"device_type": "cpu"}
        t0 = time.perf_counter()
        cpu_final, cpu_api = _sp_backend_run(ft, cpu)
        cpu_seconds = time.perf_counter() - t0
        diff = _max_param_diff(api.w_global, cpu_api.w_global)
        log(f"  {name} ({type(api.trainer).__name__}, {args.client_num_in_total} clients, "
            f"{args.comm_round} rounds): {final} in {seconds:.2f} s (rounds "
            f"{[round(x, 4) for x in api.round_times]} s, {len(steps)} client runs of "
            f"{sum(steps)} steps, {len(evals)} evals); CPU {cpu_final} in {cpu_seconds:.2f} s; "
            f"max |param diff| {diff:.3e} (atol {atol}); launches {launches}")
        if diff > atol:
            raise AssertionError(f"{name}: card vs CPU params differ by {diff:.3e}")
        out[name] = {"final": final, "seconds": seconds, "round_seconds": list(api.round_times),
                     "steps": steps, "evals": evals, "cpu_final": cpu_final,
                     "cpu_seconds": cpu_seconds, "max_param_diff": diff, "atol": atol,
                     "launches": launches, "predicted": want}
    return s2s_launches, out


def nlp_xla_phase(ft, fa):
    """14b: the seq2seq example on the round simulator, padded then packed,
    NLP_XLA_ROUNDS rounds with an eval each: round seconds, throughput(),
    the peak memory over what was allocated at the start, and the launches
    (K2 = K3 = layers x the round's steps, K1 that plus layers x the
    evals); then one more round under torch.profiler for the card's busy
    share.  Returns both runs' launches and records."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile

    out, paths = {}, []
    for pack in (False, True):
        kind = "packed" if pack else "padded"
        config = _nlp_example_config()
        config["comm_args"]["backend"] = "XLA"
        config["train_args"].update(xla_pack=pack, comm_round=NLP_XLA_ROUNDS)
        args = ft.init(ft.Arguments.from_dict(config), should_init_logs=False)
        dataset, classes = ft.data.load(args)
        model = ft.models.hub.create(args, classes)
        runner = ft.FedMLRunner(args, ft.device.get_device(args), dataset, model)
        sim = runner.runner.sim
        counts = [int(sim.local_num_dict[c]) for c in range(sim.num_clients)]
        b = sim.batch_size
        if pack:
            steps = sum(-(-n // b) for n in counts)
        else:  # every client fills its padded rows, so no batch is all padding
            if any(n != sim.padded_n for n in counts):
                raise AssertionError(f"padded round: clients {counts}, padded_n {sim.padded_n}")
            steps = len(counts) * sim.padded_n // b
        steps *= sim.epochs * NLP_XLA_ROUNDS
        fa.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        final = runner.run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = dict(fa.LAUNCHES)
        layers = model.cfg.n_layers
        want = dict.fromkeys(launches, 0)
        want.update(flash_bwd_dq=layers * steps, flash_bwd_dkv=layers * steps,
                    flash_fwd=layers * (steps + NLP_XLA_ROUNDS))
        if launches != want:
            raise AssertionError(f"{kind} s2s round: launches {launches}, predicted {want}")
        if not all(math.isfinite(x) for x in sim.round_losses) or \
                not all(bool(torch.isfinite(v).all()) for v in sim.variables.values()):
            raise AssertionError(f"{kind} s2s round: losses {sim.round_losses}")
        tp = sim.throughput()
        ids, real = sim._schedule(sim._client_sampling(1))
        ids_counts = np.where(real > 0, sim.client_counts[ids], 0)
        run = sim._run_packed_round if pack else sim._run_round
        with ft.device.fp32_matmul():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                t0 = time.perf_counter()
                float(run(1, ids, ids_counts))
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        # kernels only: the optimizer's step annotation ("Optimizer.step#...")
        # spans its kernels on the device and would count them twice
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0 and "#" not in e.key]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
        log(f"  {kind}: rounds {[round(x, 4) for x in sim.round_times]} s, median "
            f"{tp['median_round_s']:.4f} s, {tp['samples_per_sec']:,.1f} samples/s "
            f"({tp.get('tokens_per_sec', 0.0):,.0f} tokens/s), {steps} steps, losses "
            f"{[round(x, 4) for x in sim.round_losses]}; final eval {final}; peak memory "
            f"{peak / 2**20:.1f} MiB, {(peak - base) / 2**20:.1f} MiB over the start; "
            f"launches {launches}")
        log(f"  {kind}: one round under the profiler: wall {wall_ms:.1f} ms, device busy "
            f"{device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f} %); top: "
            + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                        for e in top))
        paths.append(launches)
        out[kind] = {"round_seconds": list(sim.round_times), "throughput": tp,
                     "round_losses": list(sim.round_losses), "final": final, "steps": steps,
                     "peak_memory_bytes": peak, "allocated_at_start_bytes": base,
                     "launches": launches, "predicted": want,
                     "profile": {"wall_ms": wall_ms, "device_ms": device_ms,
                                 "top": [{"name": e.key, "device_ms":
                                          e.self_device_time_total / 1e3, "calls": e.count}
                                         for e in top]}}
    return paths, out


# phase 15: the FedGraphNN family.  15a: the example configs as they stand
# (sp_fedavg_linkpred_gcn, sp_spreadgnn_moleculenet_gcn and the fedgraphnn app
# config, adam), then one short run of each head at the hub's width (hidden
# 64, 2 layers, 16 nodes, 8 features) with the linkpred example's knobs but
# SGD, each again on the CPU; 15b: ego_linkpred and freesolv on the padded
# and the packed round; 15c: decentralized FL and SpreadGNN on backend XLA
# (the in-mesh gossip round) against their sp twins, in turns.  No flash
# kernel lies on these paths: every run's counts must stay 0
GRAPH_EXAMPLES = ("examples/simulation/sp_fedavg_linkpred_gcn/fedml_config.yaml",
                  "examples/simulation/sp_spreadgnn_moleculenet_gcn/fedml_config.yaml",
                  "app/fedgraphnn/fedml_config.yaml")
# (dataset, model, optimizer) of the SGD runs
GRAPH_RUNS = (("synthetic_graph", "gcn", "FedAvg"), ("ego_linkpred", "gcn_linkpred", "FedAvg"),
              ("recsys_linkpred", "gcn_linkpred", "FedAvg"),
              ("ego_nodeclf", "gcn_nodeclf", "FedAvg"), ("freesolv", "gcn_reg", "FedAvg"),
              ("moleculenet_mtl", "gcn_mtl", "SpreadGNN"))
GRAPH_SGD = {"client_optimizer": "sgd", "learning_rate": 0.1}
GRAPH_XLA_ROUNDS = 3
# card against CPU, final params of an SGD run: fp32 with TF32 off on both,
# sums in another order, 2 rounds of 16 steps a client
GRAPH_CPU_ATOL = 1e-4
# the adam examples: two runs that differ only in roundoff part by up to 2
# lr a step (phase 14a's NLP_ADAM_CPU_ATOL_OVER_LR).  The fedgraphnn app
# config trains 4 rounds to a test loss near 1e-4, where adam's normalised
# steps take each coordinate's sign from a vanishing gradient: an "NVIDIA
# H100 80GB HBM3, 700.00 W" ended it 7.2e-3 (1.43 lr) from the CPU, while
# one-ulp changes of the init moved the CPU's own run by up to 0.057 lr
GRAPH_ADAM_CPU_ATOL_OVER_LR = NLP_ADAM_CPU_ATOL_OVER_LR
# 15c: the in-mesh round against its sp twin on the card; the padded shapes
# agree (homo partitions of a power-of-two multiple of the batch a node), so
# the two run the same kernels on the same rows
GRAPH_INMESH_ATOL = 1e-6
# 15c's decentralized run: the xla_decentralized_mnist_lr example with 64
# images a node (it has 80, which the sp trainer pads to 128 and the in-mesh
# round to 80)
GRAPH_DECENTRALIZED_TRAIN = 512


def _graph_config(path: str) -> dict:
    import yaml

    with open(os.path.join(ROOT, path)) as f:
        config = yaml.safe_load(f)
    config.setdefault("tracking_args", {})["log_file_dir"] = os.path.join(OUT_DIR, "log")
    config["data_args"]["data_cache_dir"] = os.path.join(OUT_DIR, "no_data")  # synthetic
    return config


def _graph_runner(ft, config):
    """A FedMLRunner through the entry points and its simulator object."""
    import copy

    args = ft.init(ft.Arguments.from_dict(copy.deepcopy(config)), should_init_logs=False)
    dataset, classes = ft.data.load(args)
    model = ft.models.hub.create(args, classes)
    runner = ft.FedMLRunner(args, ft.device.get_device(args), dataset, model)
    inner = runner.runner
    return runner, getattr(inner, "fl_trainer", None) or inner.sim


def _node_models(api) -> list:
    """Every model an sp run ends with: the global model (a decentralized
    run's consensus) and each node's."""
    return [api.w_global, *getattr(api, "node_models", ())]


def _models_diff(a, b):
    """(max |param diff| over every model of two runs, the leaf it is in)."""
    return max(((x[k].float().cpu() - y[k].float().cpu()).abs().max().item(), k)
               for x, y in zip(_node_models(a), _node_models(b)) for k in x)


def graph_sp_phase(ft, fa):
    """15a: the example configs (GRAPH_EXAMPLES) as they stand, then each
    head (GRAPH_RUNS) with the linkpred example's knobs but SGD, through the
    entry points on the card and again on the CPU: final params (every
    node's, for SpreadGNN) within 2 lr (adam) or GRAPH_CPU_ATOL (SGD).  The
    counts are set to 0 just before each card run and read just after; none
    may move.  Returns the launches and the runs' records."""
    import copy

    import torch

    runs = []
    for path in GRAPH_EXAMPLES:
        config = _graph_config(path)
        runs.append((path.split("/")[-2], config, GRAPH_ADAM_CPU_ATOL_OVER_LR
                     * float(config["train_args"]["learning_rate"])))
    base = _graph_config(GRAPH_EXAMPLES[0])
    for dataset, model, optimizer in GRAPH_RUNS:
        config = copy.deepcopy(base)
        config["data_args"]["dataset"] = dataset
        config["model_args"]["model"] = model
        config["train_args"].update(GRAPH_SGD, federated_optimizer=optimizer)
        if optimizer == "SpreadGNN":
            config["train_args"]["topology_neighbor_num"] = 2
        runs.append((f"{dataset} {model} {optimizer} (sgd)", config, GRAPH_CPU_ATOL))
    out, total = {}, dict.fromkeys(fa.LAUNCHES, 0)
    for name, config, atol in runs:
        runner, api = _graph_runner(ft, config)
        flags = _tf32_flags()
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = runner.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        if _tf32_flags() != flags:
            raise AssertionError(f"{name}: the run changed the TF32 flags")
        if any(launches.values()):
            raise AssertionError(f"{name}: flash kernels launched on a graph path: {launches}")
        finite = all(bool(torch.isfinite(v).all()) for m in _node_models(api) for v in m.values())
        if not finite or not math.isfinite(final["test_loss"]):
            raise AssertionError(f"{name}: {final}")
        cpu = copy.deepcopy(config)
        cpu["device_args"] = {"device_type": "cpu"}
        cpu_runner, cpu_api = _graph_runner(ft, cpu)
        t0 = time.perf_counter()
        cpu_final = cpu_runner.run()
        cpu_seconds = time.perf_counter() - t0
        diff, leaf = _models_diff(api, cpu_api)
        log(f"  {name} ({type(api).__name__}, {type(api.trainer).__name__}, "
            f"{api.args.client_num_in_total} clients, {api.args.comm_round} rounds, "
            f"{api.args.client_optimizer}): {final} in {seconds:.2f} s (rounds "
            f"{[round(x, 4) for x in api.round_times]} s); CPU {cpu_final} in "
            f"{cpu_seconds:.2f} s; max |param diff| {diff:.3e} in {leaf} over "
            f"{len(_node_models(api))} models (atol {atol:.1e})")
        if diff > atol:
            raise AssertionError(f"{name}: card vs CPU params differ by {diff:.3e}")
        for k, v in launches.items():
            total[k] += v
        out[name] = {"final": final, "seconds": seconds, "round_seconds": list(api.round_times),
                     "cpu_final": cpu_final, "cpu_seconds": cpu_seconds, "max_param_diff": diff,
                     "max_diff_leaf": leaf, "atol": atol, "launches": launches}
    return total, out


def graph_xla_phase(ft, fa):
    """15b: ego_linkpred and freesolv on the padded and the packed round,
    GRAPH_XLA_ROUNDS rounds with the linkpred example's knobs but SGD: round
    seconds, throughput(), the labels' dtype on the card (fp32: -1/0/1 pair
    labels, [B, 1] targets), finite losses, the final params within
    GRAPH_CPU_ATOL of a CPU run; then one more round under torch.profiler for
    the card's busy share and the aten ops a step.  No counter may move.
    Returns the launches and the runs' records."""
    import copy

    import torch

    out, total = {}, dict.fromkeys(fa.LAUNCHES, 0)
    for dataset, model in (("ego_linkpred", "gcn_linkpred"), ("freesolv", "gcn_reg")):
        for pack in (False, True):
            name = f"{dataset} {'packed' if pack else 'padded'}"
            config = _graph_config(GRAPH_EXAMPLES[0])
            config["data_args"]["dataset"] = dataset
            config["model_args"]["model"] = model
            config["comm_args"]["backend"] = "XLA"
            config["train_args"].update(GRAPH_SGD, xla_pack=pack, comm_round=GRAPH_XLA_ROUNDS)
            runner, sim = _graph_runner(ft, config)
            if sim.y_all.dtype != torch.float32:
                raise AssertionError(f"{name}: labels stored {sim.y_all.dtype}")
            fa.reset_launches()
            torch.cuda.synchronize()
            final = runner.run()
            torch.cuda.synchronize()
            launches = dict(fa.LAUNCHES)
            if any(launches.values()):
                raise AssertionError(f"{name}: flash kernels launched: {launches}")
            if not all(math.isfinite(x) for x in sim.round_losses) or \
                    not all(bool(torch.isfinite(v).all()) for v in sim.variables.values()):
                raise AssertionError(f"{name}: losses {sim.round_losses}")
            cpu = copy.deepcopy(config)
            cpu["device_args"] = {"device_type": "cpu"}
            cpu_runner, cpu_sim = _graph_runner(ft, cpu)
            cpu_runner.run()
            diff = _max_param_diff(sim.variables, cpu_sim.variables)
            if diff > GRAPH_CPU_ATOL:
                raise AssertionError(f"{name}: card vs CPU params differ by {diff:.3e}")
            tp = sim.throughput()
            log(f"  {name}: rounds {[round(x, 4) for x in sim.round_times]} s, median "
                f"{tp['median_round_s']:.4f} s, {tp['samples_per_sec']:,.1f} samples/s, losses "
                f"{[round(x, 4) for x in sim.round_losses]}, final eval {final}; card vs CPU "
                f"{diff:.3e} (atol {GRAPH_CPU_ATOL}); labels {tuple(sim.y_all.shape)} "
                f"{sim.y_all.dtype}, loss {sim.loss_kind}")
            prof = _profiled_round(ft, sim, name)
            for k, v in launches.items():
                total[k] += v
            out[name] = {"round_seconds": list(sim.round_times), "throughput": tp,
                         "round_losses": list(sim.round_losses), "final": final,
                         "max_param_diff": diff, "launches": launches,
                         "labels": [list(sim.y_all.shape), str(sim.y_all.dtype)],
                         "profile": prof}
    return total, out


def _profiled_round(ft, sim, name: str) -> dict:
    """Round 1's cohort once more under torch.profiler on a round simulator
    (its padded or packed round): wall and device-busy ms, steps, aten ops a
    step and the top kernels, logged and returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ids, real = sim._schedule(sim._client_sampling(1))
    ids_counts = np.where(real > 0, sim.client_counts[ids], 0)
    steps = int(sum(-(-int(n) // sim.batch_size) for n in ids_counts)) * sim.epochs
    run = sim._run_packed_round if sim.packed else sim._run_round
    with ft.device.fp32_matmul():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            float(run(1, ids, ids_counts))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0 and "#" not in e.key]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    aten = sum(1 for e in prof.profiler.kineto_results.events()
               if e.name().startswith("aten::"))
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    log(f"  {name}: one round under the profiler: wall {wall_ms:.1f} ms, device busy "
        f"{device_ms:.2f} ms ({100 * device_ms / wall_ms:.1f} %), {steps} steps, "
        f"{aten / max(steps, 1):.0f} aten ops a step; top: "
        + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                    for e in top))
    return {"wall_ms": wall_ms, "device_ms": device_ms, "steps": steps,
            "aten_ops_per_step": aten / max(steps, 1),
            "top": [{"name": e.key, "device_ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in top]}


def graph_inmesh_phase(ft, fa):
    """15c: decentralized FL on lr / mnist (the xla_decentralized_mnist_lr
    example, GRAPH_DECENTRALIZED_TRAIN images) and SpreadGNN on
    moleculenet_mtl (the sp_spreadgnn example) on backend XLA, the in-mesh
    gossip round, against their sp twins on the card, in turns (XLA, sp,
    XLA, sp): every node's final model within GRAPH_INMESH_ATOL (bit for bit
    where the kernels agree), each run's round seconds.  No counter may
    move.  Returns the launches and the runs' records."""
    import copy

    import torch

    dec = _graph_config("examples/simulation/xla_decentralized_mnist_lr/fedml_config.yaml")
    dec["data_args"]["synthetic_train_size"] = GRAPH_DECENTRALIZED_TRAIN
    spread = _graph_config(GRAPH_EXAMPLES[1])
    out, total = {}, dict.fromkeys(fa.LAUNCHES, 0)
    for name, config in (("decentralized_fl lr mnist", dec), ("SpreadGNN moleculenet_mtl", spread)):
        apis, seconds = {}, {"XLA": [], "sp": []}
        for backend in ("XLA", "sp", "XLA", "sp"):
            c = copy.deepcopy(config)
            c["comm_args"]["backend"] = backend
            runner, api = _graph_runner(ft, c)
            fa.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final = runner.run()
            torch.cuda.synchronize()
            seconds[backend].append(time.perf_counter() - t0)
            launches = dict(fa.LAUNCHES)
            if any(launches.values()):
                raise AssertionError(f"{name} {backend}: flash kernels launched: {launches}")
            if not math.isfinite(final["test_loss"]):
                raise AssertionError(f"{name} {backend}: {final}")
            apis.setdefault(backend, (api, final, list(api.round_times)))
        (xla, xla_final, xla_rounds), (sp, sp_final, sp_rounds) = apis["XLA"], apis["sp"]
        if type(xla).__name__ not in ("DecentralizedInMeshAPI", "SpreadGNNInMeshAPI"):
            raise AssertionError(f"{name}: backend XLA built {type(xla).__name__}")
        nodes = int(xla.n_nodes)
        diffs = [_max_param_diff(xla.node_params(i), sp.node_models[i]) for i in range(nodes)]
        same = all(torch.equal(xla.node_params(i)[k], sp.node_models[i][k])
                   for i in range(nodes) for k in sp.node_models[i])
        log(f"  {name}: {type(xla).__name__} {nodes} nodes, padded_n {xla.padded_n}: "
            f"{xla_final} in {[round(x, 3) for x in seconds['XLA']]} s (rounds "
            f"{[round(x, 4) for x in xla_rounds]} s); {type(sp).__name__} {sp_final} in "
            f"{[round(x, 3) for x in seconds['sp']]} s (rounds "
            f"{[round(x, 4) for x in sp_rounds]} s); max |node diff| {max(diffs):.3e} "
            f"(atol {GRAPH_INMESH_ATOL}), bit for bit {same}")
        if max(diffs) > GRAPH_INMESH_ATOL:
            raise AssertionError(f"{name}: in-mesh vs sp nodes differ by {max(diffs):.3e}")
        out[name] = {"xla_final": xla_final, "sp_final": sp_final, "seconds": seconds,
                     "xla_round_seconds": xla_rounds, "sp_round_seconds": sp_rounds,
                     "max_node_diff": max(diffs), "bit_for_bit": same}
    return total, out


# Phase 16: the vision model zoo with segmentation and detection.  16a: the
# two FedSeg example configs as they stand (the hub UNet on synthetic_seg:
# sp's FedSegAPI and the round simulator's FedAvg round); 16b: synthetic_det
# with tiny_detector on sp (FedAvg) and on the packed round; each run again on
# the CPU.  16c: one forward and one SGD step of each new hub model at the
# hub's width on the card and on the CPU.  No flash kernel lies on these
# paths, as no Pallas kernel lies on them in the JAX package: the counts, set
# to 0 when the phase starts, must read 0 when it ends
VISION_EXAMPLES = ("examples/simulation/sp_fedseg_synthetic_unet/fedml_config.yaml",
                   "examples/simulation/xla_fedseg_synthetic_unet/fedml_config.yaml")
# 16b's runs: the sp example's knobs (4 clients, 2 a round, batch 16, SGD lr
# 0.05) with FedAvg of tiny_detector on 256 synthetic_det images, 2 rounds
VISION_DET = {"dataset": "synthetic_det", "model": "tiny_detector", "train": 256, "rounds": 2}
# card against CPU, the final params of an SGD run (FedSeg's momentum 0.9
# included): fp32 with TF32 off on both, sums in another order
VISION_CPU_ATOL = 1e-4
# 16c: hub key -> (dataset whose spec sizes the model, the input: [8, 32, 32, 3]
# images, [8, 28, 28, 1] for the cnn keys, [8, 80] tokens, [8, 64] for mlp).
# The aliases build the same classes (tests/test_torch_vision_models.py)
VISION_KEYS = (("cnn", "mnist"), ("cnn_web", "mnist"), ("vgg11", "cifar10"),
               ("vgg16", "cifar10"), ("mobilenet", "cifar10"), ("mobilenet_v3", "cifar10"),
               ("efficientnet", "cifar10"), ("unet", "synthetic_seg"),
               ("tiny_detector", "synthetic_det"), ("mlp", "agnews"), ("rnn", "shakespeare"),
               ("rnn_fedshakespeare", "shakespeare"), ("rnn_stackoverflow", "shakespeare"))
VISION_BATCH = 8
VISION_LR = 0.05
# 16c's card against CPU: the logits and the params after the step, fp32 with
# TF32 off, relative to the largest |value| (the deep GroupNorm nets sum 14-28
# normalised convolutions in another order)
VISION_STEP_RTOL = 1e-4


def _final_params(api) -> dict:
    """The global model a run ends with (sp: ``w_global``; the round
    simulator: ``variables``)."""
    w = getattr(api, "w_global", None)
    return w if w is not None else api.variables


def _vision_config(path: str, det: bool = False, **train) -> dict:
    config = _graph_config(path)
    if det:
        config["data_args"].update(dataset=VISION_DET["dataset"],
                                   synthetic_train_size=VISION_DET["train"])
        config["model_args"]["model"] = VISION_DET["model"]
        config["train_args"].update(federated_optimizer="FedAvg", comm_round=VISION_DET["rounds"])
    config["train_args"].update(train)
    return config


def vision_runs_phase(ft, fa):
    """16a and 16b: each run through the entry points on the card and again
    on the CPU, final params within VISION_CPU_ATOL; its seconds, rounds,
    final eval (pixel accuracy and mIoU; class accuracy and box IoU), and for
    the round simulator's runs throughput() and one more round under
    torch.profiler.  Returns the runs' records."""
    import copy

    import torch

    runs = [(path.split("/")[-2], _vision_config(path)) for path in VISION_EXAMPLES]
    runs += [("synthetic_det tiny_detector sp", _vision_config(VISION_EXAMPLES[0], det=True)),
             ("synthetic_det tiny_detector packed",
              _vision_config(VISION_EXAMPLES[1], det=True, xla_pack=True))]
    out = {}
    for name, config in runs:
        runner, api = _graph_runner(ft, config)
        flags = _tf32_flags()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = runner.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if _tf32_flags() != flags:
            raise AssertionError(f"{name}: the run changed the TF32 flags")
        params = _final_params(api)
        if not all(bool(torch.isfinite(v).all()) for v in params.values()) or \
                not all(math.isfinite(v) for k, v in final.items() if k != "round"):
            raise AssertionError(f"{name}: {final}")
        cpu = copy.deepcopy(config)
        cpu["device_args"] = {"device_type": "cpu"}
        cpu_runner, cpu_api = _graph_runner(ft, cpu)
        t0 = time.perf_counter()
        cpu_final = cpu_runner.run()
        cpu_seconds = time.perf_counter() - t0
        diff = _max_param_diff(params, _final_params(cpu_api))
        rec = {"api": type(api).__name__, "final": final, "seconds": seconds,
               "round_seconds": list(api.round_times), "cpu_final": cpu_final,
               "cpu_seconds": cpu_seconds, "max_param_diff": diff}
        extra = ""
        if hasattr(api, "throughput"):
            tp = api.throughput()
            rec["throughput"] = tp
            extra = (f", median round {tp['median_round_s']:.4f} s, "
                     f"{tp['samples_per_sec']:,.1f} samples/s, loss {api.loss_kind}")
        log(f"  {name} ({type(api).__name__}, {api.args.client_num_in_total} clients, "
            f"{api.args.client_num_per_round} a round, {api.args.comm_round} rounds): {final} in "
            f"{seconds:.2f} s (rounds {[round(x, 4) for x in api.round_times]} s{extra}); CPU "
            f"{cpu_final} in {cpu_seconds:.2f} s; max |param diff| {diff:.3e} "
            f"(atol {VISION_CPU_ATOL})")
        if diff > VISION_CPU_ATOL:
            raise AssertionError(f"{name}: card vs CPU params differ by {diff:.3e}")
        if hasattr(api, "throughput"):
            rec["profile"] = _profiled_round(ft, api, name)
        out[name] = rec
    return out


def _vision_batch(key: str, classes: int):
    """16c's seeded inputs and labels for hub ``key``: (x, y, loss kind)."""
    rng = np.random.RandomState(16)
    b = VISION_BATCH
    if key.startswith("rnn"):
        return (rng.randint(0, 90, (b, 80)).astype(np.int64),
                rng.randint(0, 90, (b, 80)).astype(np.int64), "ce")
    if key == "mlp":
        return rng.randn(b, 64).astype(np.float32), rng.randint(0, classes, b), "ce"
    hw = (28, 28, 1) if key.startswith("cnn") else (32, 32, 3)
    x = rng.rand(b, *hw).astype(np.float32)
    if key == "unet":
        return x, rng.randint(0, classes, (b, 32, 32)), "ce"
    if key == "tiny_detector":
        y = np.concatenate([rng.randint(0, classes, (b, 1)), rng.rand(b, 4)], axis=1)
        return x, y.astype(np.float32), "det"
    return x, rng.randint(0, classes, b), "ce"


def vision_models_phase(ft):
    """16c: each VISION_KEYS model built by the hub at its width, filled from
    one seed on the card and on the CPU: one forward (eval mode) and one SGD
    step (lr VISION_LR, eval mode: dropout draws from each device's own
    generator) on VISION_BATCH seeded samples, through the engine's loss,
    inside device.fp32_matmul(); the logits and the stepped params within
    VISION_STEP_RTOL of the CPU's.  Each card forward and step is timed after
    a warm one.  Returns the records."""
    import types

    import torch
    from fedml_tpu_torch.data.data_loader import DATASET_SPECS
    from fedml_tpu_torch.ml.engine.train import LOSS_FNS, init_variables

    dev = ft.device.get_device(types.SimpleNamespace())  # the card
    out = {}
    with ft.device.fp32_matmul():
        for key, dataset in VISION_KEYS:
            classes = int(DATASET_SPECS[dataset]["classes"])
            x, y, loss_kind = _vision_batch(key, classes)
            results = []  # the card's, then the CPU's
            for device in (dev, torch.device("cpu")):
                model = ft.models.hub.create(types.SimpleNamespace(model=key, dataset=dataset),
                                             classes)
                init_variables(model, device, seed=0)
                model.eval()
                xs, ys = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
                opt = torch.optim.SGD(model.parameters(), lr=VISION_LR)

                def step():
                    logits = model(xs)
                    loss = LOSS_FNS[loss_kind](logits, ys, torch.ones(len(y), device=device))[0]
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    opt.step()
                    return logits, loss

                with torch.no_grad():
                    logits = model(xs).float()
                _, loss = step()
                params = {k: v.detach().clone() for k, v in model.named_parameters()}
                rec = {"logits": logits.cpu(), "loss": loss.item(),
                       "params": {k: v.cpu() for k, v in params.items()}}
                if device is dev:
                    for _ in range(2):  # warm, then timed
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        with torch.no_grad():
                            model(xs)
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                        step()
                        torch.cuda.synchronize()
                        t2 = time.perf_counter()
                    rec["forward_ms"], rec["step_ms"] = (t1 - t0) * 1e3, (t2 - t1) * 1e3
                    rec["n_params"] = sum(p.numel() for p in model.parameters())
                    rec["class"] = type(model).__name__
                results.append(rec)
            card, cpu = results
            scale = max(float(cpu["logits"].abs().max()), 1e-12)
            logit_err = float((card["logits"] - cpu["logits"]).abs().max()) / scale
            param_err = max(float((card["params"][k] - v).abs().max())
                            / max(float(v.abs().max()), 1e-12) for k, v in cpu["params"].items())
            log(f"  {key} ({card['class']}, {card['n_params']:,} params, {dataset}, x "
                f"{list(x.shape)}): loss {card['loss']:.5f} (CPU {cpu['loss']:.5f}), forward "
                f"{card['forward_ms']:.2f} ms, step {card['step_ms']:.2f} ms; card vs CPU "
                f"logits {logit_err:.3e}, params after the step {param_err:.3e} (rtol "
                f"{VISION_STEP_RTOL})")
            if not math.isfinite(card["loss"]) or max(logit_err, param_err) > VISION_STEP_RTOL:
                raise AssertionError(f"{key}: card vs CPU {logit_err:.3e} / {param_err:.3e}")
            out[key] = {"class": card["class"], "params": card["n_params"], "dataset": dataset,
                        "input": list(x.shape), "loss": card["loss"], "cpu_loss": cpu["loss"],
                        "forward_ms": card["forward_ms"], "step_ms": card["step_ms"],
                        "logits_rel_err": logit_err, "params_rel_err": param_err}
    return out


# Phase 17: the structural sp members (FedGAN, FedNAS, FedGKT, split NN,
# classical vertical FL) with their models (gan, darts, gkt) and the in-mesh
# FedGAN and FedNAS rounds.  17a: the five example configs as they stand;
# 17b: split NN and vertical FL on sp with the knobs of the xla_* examples
# that name them; each run again on the CPU.  17c: the in-mesh FedNAS round
# against its sp twin on the card, in turns.  No flash kernel lies on these
# paths, as no Pallas kernel lies on them in the JAX package: the counts, set
# to 0 when the phase starts, must read 0 when it ends
STRUCTURAL_EXAMPLES = ("sp_fedgan_mnist_gan", "sp_fednas_cifar10_darts", "sp_fedgkt_cifar10",
                       "xla_fedgan_mnist_gan", "xla_fednas_cifar10_darts")
STRUCTURAL_SPLIT = ("xla_split_nn_mnist_mlp", "xla_vfl_synthetic_lr")
# sp_fedgkt_cifar10 as it stands is chaotic: at its learning_rate 0.05 the
# tower's last loss of round 0 reads tens (about 2 at STRUCTURAL_GKT_TIGHT_LR),
# and a CPU run whose initial weights move by STRUCTURAL_CHAOS_EPS (relative)
# ends about as far from the unperturbed run as the card does, so no bound
# near roundoff holds between two devices.  Its card-vs-CPU gap is held,
# tree by tree, to STRUCTURAL_CHAOS_RATIO times that perturbed run's (the
# two read 0.98-1.0 apart); the same config at STRUCTURAL_GKT_TIGHT_LR is
# held to STRUCTURAL_CPU_ATOL
STRUCTURAL_CHAOS_EPS = 1e-6
STRUCTURAL_CHAOS_RATIO = 10.0
STRUCTURAL_GKT_TIGHT_LR = 0.001
# card against CPU: the SGD-driven trees (fp32, TF32 off on both, sums in
# another order) within STRUCTURAL_CPU_ATOL; the adam-driven ones (G and D,
# the alphas) within this many lr for each adam step a client takes, leaf by
# leaf, and with their update (final - initial) within
# STRUCTURAL_UPDATE_RTOL of the CPU's update in relative norm, the bar of
# tests/test_torch_structural_sp.py (port against JAX there: GAN 0.0029-0.074,
# alphas 4.1e-5; a client weighted twice or dropped, or a wrong adam
# setting, 0.20-0.55); the GAN's health score within STRUCTURAL_SCORE_ATOL
STRUCTURAL_CPU_ATOL = 1e-4
STRUCTURAL_ADAM_ATOL_OVER_LR = NLP_ADAM_CPU_ATOL_OVER_LR
STRUCTURAL_UPDATE_RTOL = {"G": 0.15, "D": 0.15, "alphas": 1e-3}
STRUCTURAL_SCORE_ATOL = 1e-3
# 17c: the in-mesh FedNAS round against its sp twin: one loop over the same
# clients in another order (tests/test_torch_gan_nas_inmesh.py's bar)
STRUCTURAL_INMESH_ATOL = {"w": 1e-5, "alphas": 1e-5}


def _example_config(name: str) -> dict:
    return _graph_config(f"examples/simulation/{name}/fedml_config.yaml")


def _structural_trees(api) -> dict:
    """{group: (variables, the optimizer that drives them)} of the final
    state of a run of phase 17 or 18."""
    name = type(api).__name__
    if name in ("FedGanAPI", "GANInMeshAPI"):
        return {"G": (api.g_params, "adam"), "D": (api.d_params, "adam")}
    if name in ("FedNASAPI", "NASInMeshAPI"):
        return {"w": (api.params, "sgd"), "alphas": ({"alphas": api.alphas}, "adam")}
    if name in ("FedGKTAPI", "GKTInMeshAPI"):
        trees = {f"client {c}": (p, "sgd") for c, p in sorted(api.client_params.items())}
        trees["server"] = (api.server_params, "sgd")
        return trees
    if name in ("SplitNNAPI", "SplitNNInMeshAPI"):
        return {"front": (api.front_params, "sgd"), "back": (api.back_params, "sgd")}
    if name == "VerticalFLAPI":
        return {"w": ({**{f"w{k}": w for k, w in enumerate(api.w)}, "b": api.b}, "sgd")}
    if name == "VFLInMeshAPI":
        return {"w": ({"w": api.w, "b": api.b}, "sgd")}
    if name == "HierarchicalInMeshAPI":
        trees = {f"group {g}": (m, "sgd") for g, m in enumerate(api.group_models)}
        trees["global"] = (api.w_global, "sgd")
        return trees
    if name == "TurboAggregateInMeshAPI":
        return {"global": (api.w_global, "sgd")}
    if name == "FedAvgAPI":
        return {"global": (api.w_global, str(api.args.client_optimizer))}
    if name == "XLASimulator":
        return {"global": (api.variables, str(api.args.client_optimizer))}
    raise AssertionError(f"not a run of phase 17 or 18: {name}")


def _adam_bound(api) -> float:
    """STRUCTURAL_ADAM_ATOL_OVER_LR lr for each adam step a client takes over
    the run (FedNAS: its most full batches)."""
    args = api.args
    if type(api).__name__ in ("FedGanAPI", "GANInMeshAPI"):
        lr, steps = api.lr, int(args.gan_local_steps) * int(args.comm_round)
    else:
        lr = api.a_lr
        steps = (max(int(n) // api.bs for n in api.local_num.values()) * int(args.epochs)
                 * int(args.comm_round))
    return STRUCTURAL_ADAM_ATOL_OVER_LR * lr * steps


def _update_rel_err(tree, ref, init) -> float:
    """||tree - ref|| / ||ref - init|| over a whole tree, in float64."""
    gap = sum(float((tree[k].double().cpu() - ref[k].double().cpu()).square().sum())
              for k in init)
    update = sum(float((ref[k].double().cpu() - init[k].double().cpu()).square().sum())
                 for k in init)
    return (gap / update) ** 0.5


def _cloned_trees(api) -> dict:
    return {g: {k: v.detach().clone() for k, v in t.items()}
            for g, (t, _) in _structural_trees(api).items()}


def _perturb_gkt(api, eps: float) -> None:
    """Every initial weight of a FedGKTAPI (the shared edge params and the
    tower) times 1 + eps N(0, 1), from a seeded CPU generator."""
    import torch

    gen = torch.Generator().manual_seed(17)
    with torch.no_grad():
        for p in [*api._proto_client_params.values(), *api.server_net.parameters()]:
            p.mul_(1 + eps * torch.randn(p.shape, generator=gen).to(p.device))


def _card_and_cpu(ft, config, name):
    """One config through the entry points on the card, then on the CPU:
    (card api, final, seconds, cpu api, the CPU run's initial trees, cpu
    final, cpu seconds)."""
    import copy

    import torch

    runner, api = _graph_runner(ft, config)
    flags = _tf32_flags()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = runner.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if _tf32_flags() != flags:
        raise AssertionError(f"{name}: the run changed the TF32 flags")
    cpu = copy.deepcopy(config)
    cpu["device_args"] = {"device_type": "cpu"}
    cpu_runner, cpu_api = _graph_runner(ft, cpu)
    cpu_init = _cloned_trees(cpu_api)
    t0 = time.perf_counter()
    cpu_final = cpu_runner.run()
    return api, final, seconds, cpu_api, cpu_init, cpu_final, time.perf_counter() - t0


def _losses_finite(api) -> bool:
    return all(math.isfinite(v) for r in api.round_losses
               for v in (r if isinstance(r, tuple) else (r,)))


def structural_runs_phase(ft):
    """17a and 17b: each run through the entry points on the card and again
    on the CPU: finite losses and trees, the final eval (d_fake_score,
    test_acc, the genotype) beside the CPU's, its seconds and rounds; each
    tree of the final state within STRUCTURAL_CPU_ATOL (SGD) or 2 lr a step
    and STRUCTURAL_UPDATE_RTOL (adam) of the CPU's, the GAN's d_fake_score
    within STRUCTURAL_SCORE_ATOL; the chaotic GKT example's gap within
    STRUCTURAL_CHAOS_RATIO times a perturbed CPU run's, the GKT config at
    STRUCTURAL_GKT_TIGHT_LR within STRUCTURAL_CPU_ATOL.  Returns the runs'
    records."""
    import copy

    import torch

    runs = [(name, _example_config(name)) for name in STRUCTURAL_EXAMPLES]
    tight = _example_config("sp_fedgkt_cifar10")
    tight["train_args"]["learning_rate"] = STRUCTURAL_GKT_TIGHT_LR
    runs.insert(3, (f"sp_fedgkt_cifar10 at learning_rate {STRUCTURAL_GKT_TIGHT_LR}", tight))
    for name in STRUCTURAL_SPLIT:
        config = _example_config(name)
        config["comm_args"]["backend"] = "sp"
        runs.append((f"{name} on sp", config))
    out = {}
    for name, config in runs:
        chaotic = name == "sp_fedgkt_cifar10"
        api, final, seconds, cpu_api, cpu_init, cpu_final, cpu_seconds = _card_and_cpu(
            ft, config, name)
        cpu = copy.deepcopy(config)
        cpu["device_args"] = {"device_type": "cpu"}
        trees, cpu_trees = _structural_trees(api), _structural_trees(cpu_api)
        spread = {}
        if chaotic:  # the gap a perturbed CPU run opens
            moved_runner, moved = _graph_runner(ft, cpu)
            _perturb_gkt(moved, STRUCTURAL_CHAOS_EPS)
            moved_runner.run()
            spread = {g: _max_param_diff(t, cpu_trees[g][0])
                      for g, (t, _) in _structural_trees(moved).items()}
        checks = {}
        for group, (tree, opt) in trees.items():
            if not all(bool(torch.isfinite(v).all()) for v in tree.values()):
                raise AssertionError(f"{name}: {group} is not finite")
            if chaotic:
                atol = STRUCTURAL_CHAOS_RATIO * spread[group]
            else:
                atol = _adam_bound(api) if opt == "adam" else STRUCTURAL_CPU_ATOL
            check = {"optimizer": opt, "atol": atol, "spread": spread.get(group),
                     "max_diff": _max_param_diff(tree, cpu_trees[group][0])}
            if opt == "adam":
                check["update_rel_err"] = _update_rel_err(tree, cpu_trees[group][0],
                                                          cpu_init[group])
                check["update_rtol"] = STRUCTURAL_UPDATE_RTOL[group]
            checks[group] = check
        if not api.round_losses or not _losses_finite(api):
            raise AssertionError(f"{name}: losses {api.round_losses}")
        score_diff = None
        if "d_fake_score" in final:
            score_diff = abs(final["d_fake_score"] - cpu_final["d_fake_score"])
        log(f"  {name} ({type(api).__name__}, {api.args.client_num_in_total} clients, "
            f"{api.args.client_num_per_round} a round, {api.args.comm_round} rounds): {final} in "
            f"{seconds:.3f} s (rounds {[round(x, 4) for x in api.round_times]} s, losses "
            f"{api.round_losses[-1]}); CPU {cpu_final} in {cpu_seconds:.3f} s; card vs CPU "
            + ", ".join(f"{g} {c['max_diff']:.3e} (atol {c['atol']:.1e}"
                        + (f", {STRUCTURAL_CHAOS_RATIO:g}x a perturbed CPU run's "
                           f"{c['spread']:.3e}" if chaotic else "")
                        + (f"; update {c['update_rel_err']:.3e} of the CPU's (rtol "
                           f"{c['update_rtol']:g})" if "update_rel_err" in c else "")
                        + f", {c['optimizer']})" for g, c in checks.items())
            + ("" if score_diff is None else
               f"; d_fake_score {score_diff:.1e} apart (atol {STRUCTURAL_SCORE_ATOL:g})"))
        bad = {g: c for g, c in checks.items()
               if c["max_diff"] > c["atol"] or c.get("update_rel_err", 0.0) > c.get(
                   "update_rtol", math.inf)}
        if bad:
            raise AssertionError(f"{name}: card vs CPU outside the bounds: {bad}")
        if score_diff is not None and score_diff > STRUCTURAL_SCORE_ATOL:
            raise AssertionError(f"{name}: d_fake_score {final['d_fake_score']} against the "
                                 f"CPU's {cpu_final['d_fake_score']}")
        out[name] = {"api": type(api).__name__, "final": final, "cpu_final": cpu_final,
                     "seconds": seconds, "cpu_seconds": cpu_seconds,
                     "round_seconds": list(api.round_times),
                     "round_losses": list(api.round_losses), "checks": checks}
    return out


def structural_inmesh_phase(ft):
    """17c: xla_fednas_cifar10_darts (the in-mesh FedNAS round) and the same
    config on sp, in turns on the card (XLA, sp, XLA, sp): the weights and
    the alphas within STRUCTURAL_INMESH_ATOL, the genotypes equal, each run's
    seconds and round seconds.  Returns the record."""
    import copy

    import torch

    config = _example_config("xla_fednas_cifar10_darts")
    apis, seconds, rounds = {}, {"XLA": [], "sp": []}, {"XLA": [], "sp": []}
    for backend in ("XLA", "sp", "XLA", "sp"):
        c = copy.deepcopy(config)
        c["comm_args"]["backend"] = backend
        runner, api = _graph_runner(ft, c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = runner.run()
        torch.cuda.synchronize()
        seconds[backend].append(time.perf_counter() - t0)
        rounds[backend].append(list(api.round_times))
        apis.setdefault(backend, (api, final))
    (mesh, mesh_final), (sp, sp_final) = apis["XLA"], apis["sp"]
    if type(mesh).__name__ != "NASInMeshAPI" or type(sp).__name__ != "FedNASAPI":
        raise AssertionError(f"built {type(mesh).__name__} and {type(sp).__name__}")
    diffs = {"w": _max_param_diff(mesh.params, sp.params),
             "alphas": _max_param_diff({"a": mesh.alphas}, {"a": sp.alphas})}
    log(f"  NASInMeshAPI {mesh_final} in {[round(x, 3) for x in seconds['XLA']]} s (rounds "
        f"{rounds['XLA']} s); FedNASAPI {sp_final} in {[round(x, 3) for x in seconds['sp']]} s "
        f"(rounds {rounds['sp']} s); in-mesh vs sp: weights {diffs['w']:.3e} (atol "
        f"{STRUCTURAL_INMESH_ATOL['w']}), alphas {diffs['alphas']:.3e} (atol "
        f"{STRUCTURAL_INMESH_ATOL['alphas']}), genotypes equal "
        f"{mesh_final['genotype'] == sp_final['genotype']}")
    if (any(diffs[k] > STRUCTURAL_INMESH_ATOL[k] for k in diffs)
            or mesh_final["genotype"] != sp_final["genotype"]):
        raise AssertionError(f"in-mesh FedNAS vs sp: {diffs}, genotypes "
                             f"{mesh_final['genotype']} and {sp_final['genotype']}")
    return {"xla_final": mesh_final, "sp_final": sp_final, "seconds": seconds,
            "round_seconds": rounds, "max_diff": diffs}


# Phase 18: the IoT autoencoder path and the in-mesh rounds of vertical FL,
# split NN, FedGKT, hierarchical FL and Turbo-Aggregate.  18a: the six example
# configs as they stand, each again on the CPU; 18b: nbaiot at its spec's
# size (115 features, 8,000 train and 1,600 test rows) on sp and on the packed
# round, each again on the CPU; 18c: the in-mesh hierarchical and
# Turbo-Aggregate rounds against their sp twins on the card, in turns.  No
# flash kernel lies on these paths, as no Pallas kernel lies on them in the
# JAX package: the counts, set to 0 when the phase starts, must read 0 when
# it ends
INMESH_EXAMPLES = ("sp_fedavg_iot_autoencoder", "xla_vfl_synthetic_lr", "xla_split_nn_mnist_mlp",
                   "xla_fedgkt_cifar10_cnn", "xla_hierarchical_fl_mnist_lr",
                   "xla_turbo_aggregate_mnist_lr")
# 18a's adam-driven autoencoder (sp_fedavg_iot_autoencoder): leaf by leaf within
# STRUCTURAL_ADAM_ATOL_OVER_LR lr for each adam step a client takes, and its
# update within IOT_UPDATE_RTOL of the CPU's (relative norm), the bar of 17a's
# alphas; the SGD-driven trees within STRUCTURAL_CPU_ATOL, xla_fedgkt_cifar10_cnn
# (lr 0.05 with momentum, as the chaotic sp_fedgkt_cifar10) within it or, past
# it, within STRUCTURAL_CHAOS_RATIO times the gap a CPU run opens when its
# initial weights move by STRUCTURAL_CHAOS_EPS
IOT_UPDATE_RTOL = 1e-3
# 18b: the anomaly threshold and the test set's error sum, card against CPU,
# relative: runs with SGD at IOT_SPEC_LR within IOT_EVAL_RTOL; runs with the
# IoT example's adam within the larger of IOT_EVAL_RTOL and
# STRUCTURAL_CHAOS_RATIO times the largest gap of IOT_WITNESS_SEEDS CPU runs
# whose weights are rounded once more after every step (each times
# 1 + IOT_WITNESS_EPS N(0, 1), from a CPU generator of the seed), and, where
# past IOT_EVAL_RTOL, again on the card with the CPU's single-tensor adam
# (foreach off) within IOT_EVAL_RTOL.  At this size (125 adam steps a client
# a round) an "NVIDIA H100 80GB HBM3, 700.00 W" parted from its host's CPU by
# 6.7e-3 in the threshold after 2 rounds on sp, one such witness by 6.9e-3,
# the card's single-tensor adam by 5.8e-6 (PERF.md)
IOT_EVAL_RTOL = 1e-4
IOT_SPEC_LR = 0.05
IOT_WITNESS_EPS = 2.0 ** -24
IOT_WITNESS_SEEDS = (1, 2, 3, 4)
# 18c: in-mesh against sp on one card, clients of 64 rows in batches of 16, so
# the sp bucket and padded_n agree: the in-mesh rounds are their sp twins with
# only the padding changed, so every tree is equal bit for bit


def _adam_steps(api) -> int:
    """The adam steps a client of an sp run takes, at most."""
    args = api.args
    most = max(api.train_data_local_num_dict.values())
    return -(-most // int(args.batch_size)) * int(args.epochs) * int(args.comm_round)


def _ae_threshold(api, variables) -> dict:
    """The anomaly threshold (median + 3 * 1.4826 * MAD of the test errors,
    ModelTrainerAE's) and the errors' sum of ``variables`` on the run's test
    set, in one forward on the run's device."""
    import torch

    from fedml_tpu_torch.ml.engine.train import load_variables
    from fedml_tpu_torch.ml.trainer.ae_trainer import median

    x, _flags = api.test_data_global if hasattr(api, "test_data_global") else api.test_global
    module = api.module
    load_variables(module, variables)
    with torch.no_grad():
        xs = torch.from_numpy(np.asarray(x, np.float32)).to(next(module.parameters()).device)
        err = torch.square(module(xs) - xs.reshape(xs.shape[0], -1)).mean(dim=-1)
        med = median(err)
        thresh = med + 3.0 * 1.4826 * median((err - med).abs())
    return {"threshold": float(thresh), "error_sum": float(err.sum())}


def inmesh_examples_phase(ft):
    """18a: the six example configs as they stand, on the card and on the
    CPU: finite losses and trees, the final eval beside the CPU's, the
    seconds; each tree within its bound (see INMESH_EXAMPLES).  Returns the
    runs' records."""
    import copy

    import torch

    out = {}
    for name in INMESH_EXAMPLES:
        config = _example_config(name)
        api, final, seconds, cpu_api, cpu_init, cpu_final, cpu_seconds = _card_and_cpu(
            ft, config, name)
        trees, cpu_trees = _structural_trees(api), _structural_trees(cpu_api)
        checks, bad = {}, {}
        for group, (tree, opt) in trees.items():
            if not all(bool(torch.isfinite(v).all()) for v in tree.values()):
                raise AssertionError(f"{name}: {group} is not finite")
            check = {"optimizer": opt, "max_diff": _max_param_diff(tree, cpu_trees[group][0])}
            if opt == "adam":
                check["atol"] = (STRUCTURAL_ADAM_ATOL_OVER_LR * float(api.args.learning_rate)
                                 * _adam_steps(api))
                check["update_rel_err"] = _update_rel_err(tree, cpu_trees[group][0],
                                                          cpu_init[group])
                check["update_rtol"] = IOT_UPDATE_RTOL
            else:
                check["atol"] = STRUCTURAL_CPU_ATOL
            checks[group] = check
        if name == "xla_fedgkt_cifar10_cnn" and any(
                c["max_diff"] > c["atol"] for c in checks.values()):
            cpu = copy.deepcopy(config)
            cpu["device_args"] = {"device_type": "cpu"}
            moved_runner, moved = _graph_runner(ft, cpu)
            _perturb_gkt(moved, STRUCTURAL_CHAOS_EPS)
            moved_runner.run()
            for group, (tree, _) in _structural_trees(moved).items():
                spread = _max_param_diff(tree, cpu_trees[group][0])
                checks[group].update(spread=spread, atol=STRUCTURAL_CHAOS_RATIO * spread)
        for group, c in checks.items():
            if c["max_diff"] > c["atol"] or c.get("update_rel_err", 0.0) > c.get(
                    "update_rtol", math.inf):
                bad[group] = c
        losses = getattr(api, "round_losses", None)
        if losses is not None and (not losses or not _losses_finite(api)):
            raise AssertionError(f"{name}: losses {losses}")
        if not all(math.isfinite(v) for v in final.values() if isinstance(v, float)):
            raise AssertionError(f"{name}: {final}")
        log(f"  {name} ({type(api).__name__}, {api.args.client_num_in_total} clients, "
            f"{api.args.client_num_per_round} a round, {api.args.comm_round} rounds): {final} in "
            f"{seconds:.3f} s" + (f" (rounds {[round(x, 4) for x in api.round_times]} s, last "
                                   f"loss {losses[-1]})" if losses else "")
            + f"; CPU {cpu_final} in {cpu_seconds:.3f} s; card vs CPU "
            + ", ".join(f"{g} {c['max_diff']:.3e} (atol {c['atol']:.1e}"
                        + (f", {STRUCTURAL_CHAOS_RATIO:g}x a perturbed CPU run's "
                           f"{c['spread']:.3e}" if "spread" in c else "")
                        + (f"; update {c['update_rel_err']:.3e} of the CPU's (rtol "
                           f"{c['update_rtol']:g})" if "update_rel_err" in c else "")
                        + f", {c['optimizer']})" for g, c in checks.items()))
        if bad:
            raise AssertionError(f"{name}: card vs CPU outside the bounds: {bad}")
        out[name] = {"api": type(api).__name__, "final": final, "cpu_final": cpu_final,
                     "seconds": seconds, "cpu_seconds": cpu_seconds,
                     "round_seconds": list(getattr(api, "round_times", [])),
                     "round_losses": list(losses or []), "checks": checks}
    return out


def _rounding_witness(ft, config, eps: float, seed: int):
    """``config`` on the CPU with every weight times 1 + eps N(0, 1) after
    each optimizer step (a CPU generator seeded ``seed``): its api."""
    import copy

    import torch
    from torch.optim.optimizer import register_optimizer_step_post_hook

    gen = torch.Generator().manual_seed(seed)

    def perturb(opt, _args, _kwargs):
        with torch.no_grad():
            for group in opt.param_groups:
                for p in group["params"]:
                    p.mul_(1 + eps * torch.randn(p.shape, generator=gen))

    cpu = copy.deepcopy(config)
    cpu["device_args"] = {"device_type": "cpu"}
    handle = register_optimizer_step_post_hook(perturb)
    try:
        runner, api = _graph_runner(ft, cpu)
        runner.run()
    finally:
        handle.remove()
    return api


def _single_tensor_adam_run(ft, config):
    """``config`` as it stands with ``torch.optim.Adam``'s foreach off, the
    CPU's default: its api."""
    import functools

    import torch

    init = torch.optim.Adam.__init__
    torch.optim.Adam.__init__ = functools.partialmethod(init, foreach=False)
    try:
        runner, api = _graph_runner(ft, config)
        runner.run()
    finally:
        torch.optim.Adam.__init__ = init
    return api


def iot_spec_phase(ft):
    """18b: nbaiot at its spec's size with sp_fedavg_iot_autoencoder's knobs
    (adam) and again with SGD at IOT_SPEC_LR, on sp and on the packed round,
    on the card and on the CPU: test_acc and test_anomaly_recall beside the
    CPU's, the threshold and the error sum of the final model within their
    bound (IOT_EVAL_RTOL; for adam, past it, STRUCTURAL_CHAOS_RATIO times the
    rounding witnesses' largest gap, and the card's run with single-tensor
    adam within IOT_EVAL_RTOL), the seconds.  Returns the records."""
    import copy

    base = _example_config("sp_fedavg_iot_autoencoder")
    base["data_args"].update(dataset="nbaiot", synthetic_train_size=0)
    out = {}
    for opt, lr in (("adam", base["train_args"]["learning_rate"]), ("sgd", IOT_SPEC_LR)):
        for label, backend, pack in (("sp", "sp", False), ("packed", "XLA", True)):
            c = copy.deepcopy(base)
            c["comm_args"]["backend"] = backend
            c["train_args"].update(xla_pack=pack, client_optimizer=opt, learning_rate=lr)
            name = f"nbaiot {opt} on {label}"
            api, final, seconds, cpu_api, _init, cpu_final, cpu_seconds = _card_and_cpu(
                ft, c, name)
            got = _ae_threshold(api, _structural_trees(api)["global"][0])
            want = _ae_threshold(cpu_api, _structural_trees(cpu_api)["global"][0])
            rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
            bound = {k: IOT_EVAL_RTOL for k in want}
            spread = {}
            if opt == "adam":
                for seed in IOT_WITNESS_SEEDS:
                    witness = _rounding_witness(ft, c, IOT_WITNESS_EPS, seed)
                    w = _ae_threshold(witness, _structural_trees(witness)["global"][0])
                    spread = {k: max(spread.get(k, 0.0), abs(w[k] - want[k]) / abs(want[k]))
                              for k in want}
                bound = {k: max(IOT_EVAL_RTOL, STRUCTURAL_CHAOS_RATIO * spread[k])
                         for k in want}
            single = {}
            if opt == "adam" and any(rel[k] > IOT_EVAL_RTOL for k in want):
                s_api = _single_tensor_adam_run(ft, c)
                s_eval = _ae_threshold(s_api, _structural_trees(s_api)["global"][0])
                single = {k: abs(s_eval[k] - want[k]) / abs(want[k]) for k in want}
            n_train = sum(len(v[1]) for v in (api.train_data_local_dict.values()
                                              if hasattr(api, "train_data_local_dict")
                                              else api.local_train_dict.values()))
            n_test = len((api.test_data_global if hasattr(api, "test_data_global")
                          else api.test_global)[1])
            log(f"  {name} ({type(api).__name__}, {n_train} train and {n_test} test rows, "
                f"115 features, lr {lr:g}): test_acc {final['test_acc']} (CPU "
                f"{cpu_final['test_acc']}), test_anomaly_recall {final['test_anomaly_recall']} "
                f"(CPU {cpu_final['test_anomaly_recall']}) in {seconds:.3f} s (CPU "
                f"{cpu_seconds:.3f} s); "
                + "; ".join(f"{k} {got[k]:.6f} (CPU {want[k]:.6f}, rel {rel[k]:.3e}, bound "
                            f"{bound[k]:.3e}"
                            + (f" = max({IOT_EVAL_RTOL:g}, {STRUCTURAL_CHAOS_RATIO:g} x the "
                               f"witnesses' {spread[k]:.3e})" if spread else "") + ")"
                            for k in want)
                + (f"; the card with single-tensor adam: rel {single} (rtol {IOT_EVAL_RTOL:g})"
                   if single else ""))
            if (n_train, n_test) != (8000, 1600) or any(rel[k] > bound[k] for k in want) or any(
                    v > IOT_EVAL_RTOL for v in single.values()):
                raise AssertionError(f"{name}: {n_train} and {n_test} rows, {got} against "
                                     f"{want}, bound {bound}, single-tensor adam {single}")
            out[f"{opt} {label}"] = {"final": final, "cpu_final": cpu_final, "seconds": seconds,
                                     "cpu_seconds": cpu_seconds, "eval": got, "cpu_eval": want,
                                     "rel": rel, "bound": bound, "witness_spread": spread,
                                     "single_tensor_adam_rel": single}
    return out


def group_inmesh_phase(ft):
    """18c: the in-mesh hierarchical and Turbo-Aggregate rounds (their example
    configs with clients of 64 rows) against their sp twins on the card, in
    turns (XLA, sp, XLA, sp): every tree equal bit for bit, each run's
    seconds and round seconds.  Returns the records."""
    import copy

    import torch

    out = {}
    for name in ("xla_hierarchical_fl_mnist_lr", "xla_turbo_aggregate_mnist_lr"):
        config = _example_config(name)
        config["data_args"].update(partition_method="homo",
                                   synthetic_train_size=64 * config["train_args"][
                                       "client_num_in_total"])
        apis, seconds, rounds = {}, {"XLA": [], "sp": []}, {"XLA": [], "sp": []}
        for backend in ("XLA", "sp", "XLA", "sp"):
            c = copy.deepcopy(config)
            c["comm_args"]["backend"] = backend
            runner, api = _graph_runner(ft, c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final = runner.run()
            torch.cuda.synchronize()
            seconds[backend].append(time.perf_counter() - t0)
            rounds[backend].append([round(x, 4) for x in api.round_times])
            apis.setdefault(backend, (api, final))
        (mesh, mesh_final), (sp, sp_final) = apis["XLA"], apis["sp"]
        pairs = [(mesh.w_global, sp.w_global)] + list(zip(getattr(mesh, "group_models", []),
                                                          getattr(sp, "group_models", [])))
        worst = max(float((a[k] - b[k]).abs().max()) for a, b in pairs for k in b)
        log(f"  {name}: {type(mesh).__name__} (padded_n {mesh.padded_n}) {mesh_final} in "
            f"{[round(x, 3) for x in seconds['XLA']]} s (rounds {rounds['XLA']} s); "
            f"{type(sp).__name__} {sp_final} in {[round(x, 3) for x in seconds['sp']]} s (rounds "
            f"{rounds['sp']} s); in-mesh vs sp: max |diff| {worst:.3e} over {len(pairs)} trees "
            "(bound: equal)")
        if worst > 0 or mesh_final != sp_final:
            raise AssertionError(f"{name}: in-mesh vs sp {worst}, {mesh_final} against {sp_final}")
        out[name] = {"xla_final": mesh_final, "sp_final": sp_final, "seconds": seconds,
                     "round_seconds": rounds, "max_diff": worst}
    return out


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

    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    starts = {}  # phase -> seconds from the start

    def phase(title: str) -> None:
        starts[title.split(":")[0]] = time.perf_counter() - t_start
        log(f"== phase {title} (at {starts[title.split(':')[0]]:.1f} s)")

    phase("1: device and build")
    card = card_line()
    log(f"  card: {card}")
    log(f"  python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    flags_found = _tf32_flags()
    # phases 1-11 keep full-fp32 products (TF32 off) from here, as the
    # simulators do inside their runs; the flags found come back for phase 12
    pin = contextlib.ExitStack()
    pin.enter_context(ft.device.fp32_matmul())
    log(f"  tf32 flags (cuda.matmul, cudnn): found {flags_found}, phases 1-11 {_tf32_flags()}")
    t0 = time.perf_counter()
    builds = build.build()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{s} {b['seconds']:.1f} s" for s, b in builds.items()))
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
        for src, b in builds.items():
            f.write(f"== {src}\n{b['log']}\n")
    ptxas = ptxas_check(build, builds)

    phase("2: kernels against their plain versions")
    rows = kernel_phase(fa)
    fold_rows = fold_phase(fa)

    phase("3: reference (card vs CPU: one FedAvg round; one sp SGD step; one packed "
        "ResNet-20 round; 2 packed rounds of SCAFFOLD and of FedNova)")
    ref_err = reference_phase(ft)
    sp_ref = sp_reference_phase()
    packed_ref = packed_reference_phase(ft)
    packed_zoo_ref = packed_zoo_reference_phase(ft)

    phase("4: slice 1 (FedAvg, hub transformer, shakespeare, 3 rounds)")
    launches, final, tp, round_times, losses = slice_phase(ft, fa)

    phase("5: profile of one client's local training")
    prof = profile_phase(ft, fa)

    phase("6: slice 2 (sequence-parallel TransformerLM, bench width, sp 4)")
    sp_launches, sp_slice = sp_slice_phase(fa)

    phase("7: single card (bench.py's TransformerLM leg, bf16, B 8 x L 1024)")
    single_launches, single = single_card_phase(ft, fa)

    phase(f"8: slice 3 (bench.py's ResNet-56 packed FedAvg round, "
          f"{BENCH_CONFIG['train_args']['comm_round']} rounds)")
    resnet_slice, (cifar, classes) = resnet_slice_phase(ft, fa)

    phase(f"10a: the algorithm zoo at the north-star width (ResNet-56, a cohort of "
          f"{ZOO_COHORT}, {ZOO_ROUNDS} rounds each)")
    zoo = zoo_phase(ft, fa, cifar, classes)
    phase("10b: the grad hooks under the flash kernels (SCAFFOLD, FedDyn on slice 1)")
    zoo_launches, zoo["slice1_hooks"] = zoo_hooks_phase(ft, fa)

    phase(f"11a: the trust path at the north-star width (ResNet-56, {TRUST_ROUNDS} round a "
          "run)")
    trust = trust_phase(ft, fa, cifar, classes)
    phase("11c: the trust path under the flash kernels (krum + LDP on slice 1)")
    trust_launches, trust["slice1"] = trust_hooks_phase(ft, fa)
    pin.close()
    if _tf32_flags() != flags_found:
        raise AssertionError(f"tf32 flags {_tf32_flags()} after phase 11, found {flags_found}")

    t12 = time.perf_counter()
    sp_backend = {"tf32_flags": flags_found}
    phase("12a: the sp backend: the default config through run_simulation(), then the "
        "sp FedAvg example configs (card vs CPU)")
    sp_backend["configs"] = sp_backend_default_phase(ft, fa)
    phase(f"12b: the sp backend at the north-star width (ResNet-56, a cohort of "
          f"{SP_BACKEND_COHORT}, {SP_BACKEND_ROUNDS} rounds)")
    sp_backend["resnet"] = sp_backend_resnet_phase(ft, fa, cifar, classes,
                                                   resnet_slice["throughput"])
    phase("12c: the sp backend under the flash kernels (slice 1's TransformerLM, "
        "2 rounds)")
    sp_backend_launches, sp_backend["transformer"] = sp_backend_transformer_phase(ft, fa)
    sp_backend["seconds"] = time.perf_counter() - t12
    log(f"  phase 12 in {sp_backend['seconds']:.1f} s")

    t13 = time.perf_counter()
    sp_zoo = {"tf32_flags": flags_found}
    phase("13a: the sp zoo's example configs, FedBuff and AsyncFedAvg (card vs CPU); "
        "FedBuff against FedAvgAPI in its equivalence configuration")
    sp_zoo["configs"] = sp_zoo_examples_phase(ft, fa)
    phase(f"13b: the sp zoo at the north-star width (ResNet-56, a cohort of "
        f"{SP_ZOO_COHORT}, 2 rounds)")
    sp_zoo["resnet"] = sp_zoo_resnet_phase(ft, fa, cifar, classes)
    del cifar
    phase("13c: SCAFFOLD and FedSGD on sp under the flash kernels (slice 1's "
        "TransformerLM, 2 rounds each)")
    sp_zoo_launches, sp_zoo["transformer"] = sp_zoo_transformer_phase(ft, fa)
    if _tf32_flags() != flags_found:
        raise AssertionError(f"tf32 flags {_tf32_flags()} after phase 13, found {flags_found}")
    sp_zoo["seconds"] = time.perf_counter() - t13
    log(f"  phase 13 in {sp_zoo['seconds']:.1f} s")

    t14 = time.perf_counter()
    nlp = {"tf32_flags": flags_found}
    phase(f"14a: the FedNLP family on sp: {NLP_EXAMPLE} (K1-K3), then "
          + ", ".join(f"{d} {m}" for d, m in NLP_RUNS) + " (card vs CPU)")
    nlp_launches, nlp["sp"] = nlp_sp_phase(ft, fa)
    phase(f"14b: {NLP_EXAMPLE} on the padded and packed rounds ({NLP_XLA_ROUNDS} rounds)")
    nlp_xla_launches, nlp["xla"] = nlp_xla_phase(ft, fa)
    if _tf32_flags() != flags_found:
        raise AssertionError(f"tf32 flags {_tf32_flags()} after phase 14, found {flags_found}")
    phase("14c: K1-K3 on the seq2seq path")
    nlp["s2s_kernels"] = [r for r in rows if r["case"] in ("s2s_train", "s2s_eval")]
    for r in nlp["s2s_kernels"]:
        log(f"  {r['case']:10s} {r['kernel']:14s} err {r['max_abs_err']:.3e} (least atol "
            f"{r['least_atol']:.3e}), kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, {r['library']} "
            f"{r['library_ms']:.4f} ms, over library {r['over_library']:.2f}")
    log(f"  14a's {NLP_EXAMPLE} run launched {nlp_launches} (predicted "
        f"{nlp['sp'][NLP_EXAMPLE]['predicted']})")
    nlp["seconds"] = time.perf_counter() - t14
    log(f"  phase 14 in {nlp['seconds']:.1f} s")

    t15 = time.perf_counter()
    graph = {"tf32_flags": flags_found}
    phase("15a: the FedGraphNN family on sp: the example configs, then "
          + ", ".join(f"{d} {m}" for d, m, _ in GRAPH_RUNS) + " (card vs CPU)")
    graph_launches, graph["sp"] = graph_sp_phase(ft, fa)
    phase(f"15b: ego_linkpred and freesolv on the padded and packed rounds "
          f"({GRAPH_XLA_ROUNDS} rounds)")
    graph_xla_launches, graph["xla"] = graph_xla_phase(ft, fa)
    phase("15c: decentralized FL and SpreadGNN on backend XLA (the in-mesh gossip round) "
          "against their sp twins, in turns")
    graph_mesh_launches, graph["inmesh"] = graph_inmesh_phase(ft, fa)
    if _tf32_flags() != flags_found:
        raise AssertionError(f"tf32 flags {_tf32_flags()} after phase 15, found {flags_found}")
    graph["seconds"] = time.perf_counter() - t15
    log(f"  phase 15 in {graph['seconds']:.1f} s")

    t16 = time.perf_counter()
    vision = {"tf32_flags": flags_found}
    fa.reset_launches()
    phase("16a-b: the FedSeg examples (sp, XLA), then synthetic_det tiny_detector on sp and "
          "the packed round (card vs CPU)")
    vision["runs"] = vision_runs_phase(ft, fa)
    phase("16c: one forward and one SGD step of each new hub model (card vs CPU)")
    vision["models"] = vision_models_phase(ft)
    vision_launches = dict(fa.LAUNCHES)
    log(f"  phase 16 launches {vision_launches}")
    if any(vision_launches.values()):
        raise AssertionError(f"flash kernels launched on a vision path: {vision_launches}")
    if _tf32_flags() != flags_found:
        raise AssertionError(f"tf32 flags {_tf32_flags()} after phase 16, found {flags_found}")
    vision["launches"] = vision_launches
    vision["seconds"] = time.perf_counter() - t16
    log(f"  phase 16 in {vision['seconds']:.1f} s")

    t17 = time.perf_counter()
    structural = {"tf32_flags": flags_found}
    fa.reset_launches()
    phase("17a-b: the structural example configs (FedGAN, FedNAS, FedGKT; sp and XLA), then "
          "split NN and vertical FL on sp (card vs CPU)")
    structural["runs"] = structural_runs_phase(ft)
    phase("17c: the in-mesh FedNAS round against its sp twin, in turns")
    structural["inmesh"] = structural_inmesh_phase(ft)
    structural_launches = dict(fa.LAUNCHES)
    log(f"  phase 17 launches {structural_launches}")
    if any(structural_launches.values()):
        raise AssertionError(f"flash kernels launched on a structural path: "
                             f"{structural_launches}")
    if _tf32_flags() != flags_found:
        raise AssertionError(f"tf32 flags {_tf32_flags()} after phase 17, found {flags_found}")
    structural["launches"] = structural_launches
    structural["seconds"] = time.perf_counter() - t17
    log(f"  phase 17 in {structural['seconds']:.1f} s")

    t18 = time.perf_counter()
    inmesh = {"tf32_flags": flags_found}
    fa.reset_launches()
    phase("18a: the IoT example and the in-mesh VFL, split NN, FedGKT, hierarchical and "
          "Turbo-Aggregate examples (card vs CPU)")
    log(f"  card: {card}")
    inmesh["runs"] = inmesh_examples_phase(ft)
    phase("18b: nbaiot at its spec's size on sp and the packed round (card vs CPU)")
    inmesh["iot"] = iot_spec_phase(ft)
    phase("18c: the in-mesh hierarchical and Turbo-Aggregate rounds against their sp twins, "
          "in turns")
    inmesh["group"] = group_inmesh_phase(ft)
    inmesh_launches = dict(fa.LAUNCHES)
    log(f"  phase 18 launches {inmesh_launches} (predicted: none)")
    if any(inmesh_launches.values()):
        raise AssertionError(f"flash kernels launched on phase 18's paths: {inmesh_launches}")
    if _tf32_flags() != flags_found:
        raise AssertionError(f"tf32 flags {_tf32_flags()} after phase 18, found {flags_found}")
    inmesh["launches"] = inmesh_launches
    inmesh["seconds"] = time.perf_counter() - t18
    log(f"  phase 18 in {inmesh['seconds']:.1f} s")

    phase("9: results")

    kernels = kernels_line(rows + fold_rows,
                           (launches, sp_launches, single_launches, zoo_launches, trust_launches,
                            sp_backend_launches, sp_zoo_launches, nlp_launches,
                            *nlp_xla_launches, graph_launches, graph_xla_launches,
                            graph_mesh_launches, vision_launches, structural_launches,
                            inmesh_launches))
    bench = bench_bf16_summary(rows)
    with open(os.path.join(OUT_DIR, "results.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "ptxas": ptxas, "cases": rows, "folds": fold_rows, "bench_bf16": bench,
                   "reference_max_param_diff": ref_err,
                   "sp_reference": sp_ref, "packed_reference": packed_ref,
                   "packed_zoo_reference": packed_zoo_ref,
                   "launches": launches,
                   "final_eval": final, "throughput": tp, "round_times": round_times,
                   "round_losses": losses, "kernels": kernels, "profile": prof,
                   "sp_slice": sp_slice, "single_card": single,
                   "resnet_slice": resnet_slice, "zoo": zoo,
                   "zoo_launches": zoo_launches, "trust": trust,
                   "trust_launches": trust_launches, "sp_backend": sp_backend,
                   "sp_backend_launches": sp_backend_launches, "sp_zoo": sp_zoo,
                   "sp_zoo_launches": sp_zoo_launches, "nlp": nlp,
                   "nlp_launches": nlp_launches, "nlp_xla_launches": nlp_xla_launches,
                   "graph": graph, "vision": vision, "structural": structural,
                   "inmesh": inmesh,
                   "phase_starts": starts, "seconds": time.perf_counter() - t_start}, f,
                  indent=1)
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
