#!/usr/bin/env python3
"""The CPU witnesses of chip_smoke.py phase 21's bounds on the chunked round.

    python3 chunk_witness.py

Runs, on the CPU through the entry points, the two comparisons that phase 21
makes on the card, from one start each: 21a's warm round of slice 1 at its
full hub width (homo, 10 clients a round) with xla_client_chunk 5 against
the unchunked round, and 21b's ResNet-56-bn round at bench width (bf16 over
fp32; 2 clients of one batch of 64 here, 8 on the card) with chunk 2
against unchunked.  It prints the largest gap of the globals (21a) and of
the running averages and the params (21b); phase 21 holds the card's 21a
gap to 10x the first (CHUNK_SLICE_ATOL).  Takes about three minutes on
four threads.
"""

import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs
    import fedml_tpu_torch as ft
    from fedml_tpu_torch.models.convert import is_batch_stat

    torch.set_num_threads(int(os.environ.get("THREADS", "4")))
    t0 = time.perf_counter()
    out = {}
    config = copy.deepcopy(cs.SLICE_CONFIG)
    config["data_args"]["partition_method"] = "homo"
    config["train_args"]["comm_round"] = 1
    config["validation_args"]["frequency_of_the_test"] = 0
    config["device_args"]["device_type"] = "cpu"
    sims = {k: r.runner.sim for k, r in cs._chunk_runners(ft, config, cs.CHUNK_SLICE_K).items()}
    for sim in sims.values():
        sim.train()
    out["21a_global_gap"] = cs._max_param_diff(sims["chunk"].variables, sims["plain"].variables)
    print(f"21a: globals chunked vs unchunked {out['21a_global_gap']:.3e} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    config = copy.deepcopy(cs.BENCH_CONFIG)
    config["data_args"].update(partition_method="homo",
                               synthetic_train_size=100 * cs.CHUNK_RESNET_ROWS)
    config["train_args"].update(xla_pack=False, client_num_per_round=2)
    config["model_args"]["model_norm"] = "bn"
    config["device_args"]["device_type"] = "cpu"
    sims = {k: r.runner.sim for k, r in cs._chunk_runners(ft, config, 2).items()}
    for sim in sims.values():
        sim.train()
    a, b = sims["chunk"].variables, sims["plain"].variables
    out["21b_bn_running_average_gap"] = max((a[k] - b[k]).abs().max().item()
                                            for k in a if is_batch_stat(k))
    out["21b_bn_params_gap"] = max((a[k].float() - b[k].float()).abs().max().item()
                                   for k in a if not is_batch_stat(k))
    print(f"21b bn: running averages {out['21b_bn_running_average_gap']:.3e}, params "
          f"{out['21b_bn_params_gap']:.3e} ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
