"""Controls for chip_smoke.py's phase-20a bound on BatchNorm's card run.

Phase 20a holds the card's fp32 round of ResNet-56-bn against a float64 CPU
run, and passes while the card's largest gap (in the params, the running
means and the running variances) stays within ``BN_REF_RATIO`` times the
fp32 CPU run's gap.  This script runs the same reference once more, with
the card's round degraded on purpose, to show which faults that bound
catches:

* ``sound``: the card's round as phase 20a runs it (TF32 off);
* ``tf32``: the simulator's TF32 guard replaced by one that turns TF32 on,
  so every convolution and product of the card's round rounds its inputs to
  TF32;
* ``bf16_stats``: each BatchNorm batch mean and variance rounded to bf16,
  a statistic error of the card alone.

The fp32 CPU and float64 runs are made once and shared.  Nothing of the
package is edited: each fault is patched in for its card run and taken out
after it.  Run it on a CUDA machine from the repo's root::

    python3 bn_ref_control.py

It prints each run's gaps and ratios, the card's name and power limit, and
as its last line one JSON object; it writes the same object to
``chiprun_out/bn_ref_control.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import chip_smoke as cs


@contextlib.contextmanager
def _tf32_on():
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def _fault(name: str):
    """The card run's fault ``name`` patched in for the block."""
    import torch

    from fedml_tpu_torch.simulation.xla import fed_sim

    if name == "tf32":
        saved, fed_sim.fp32_matmul = fed_sim.fp32_matmul, _tf32_on
        try:
            yield
        finally:
            fed_sim.fp32_matmul = saved
    elif name == "bf16_stats":  # BatchNorm is the one caller of var_mean in the port
        var_mean = torch.var_mean

        def rounded(*a, **kw):
            return tuple(t.bfloat16().to(t.dtype) for t in var_mean(*a, **kw))

        torch.var_mean = rounded
        try:
            yield
        finally:
            torch.var_mean = var_mean
    else:
        yield


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bn_ref_control: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.ROOT)
    import fedml_tpu_torch as ft

    card = cs.card_line()
    cs.log(f"card: {card}")
    finals = cs.bn_float64_runs(ft, runs=("cpu", "float64"))
    out = {"card": card, "bound_ratio": cs.BN_REF_RATIO, "runs": {}}
    for name in ("sound", "tf32", "bf16_stats"):
        with _fault(name):
            run = cs.bn_float64_runs(ft, runs=("card",), start=finals["start"])
        finals[name] = run["card"]
        gaps, ratios = cs.bn_float64_gaps(finals, card=name)
        caught = max(ratios.values()) > cs.BN_REF_RATIO
        out["runs"][name] = {"gaps": gaps, "ratios": ratios, "caught": caught,
                             "seconds": run["card"][1], "loss": run["card"][2]}
        cs.log(f"{name}: {cs.bn_gaps_text(gaps, ratios)}; loss {run['card'][2]:.6f}; "
               f"{'caught' if caught else 'passes'} at {cs.BN_REF_RATIO}x")
    os.makedirs(os.path.join(cs.ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(cs.ROOT, "chiprun_out", "bn_ref_control.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
