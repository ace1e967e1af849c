"""Single-process algorithm registry of the port (counterpart of
``fedml_tpu/simulation/sp/__init__.py``).

FedAvg and its zoo are ported, each a subclass of ``FedAvgAPI`` at its JAX
twin's path; ``fl_mode: async`` with FedAvg runs FedBuff.  FedSeg and the
structural members (FedGAN, FedNAS, FedGKT, split NN, classical vertical FL)
each run a loop of their own (``fedseg/``, ``fedgan/``, ``fednas/``,
``fedgkt/``, ``split_nn/``, ``classical_vertical_fl/``), as their JAX twins
do, and share ``fedavg_api.own_loop_setup``'s checks.

The JAX members do not all pass through the trust hooks that ``FedAvgAPI``
runs: some replace the client's training (no local DP after-hook), some
aggregate with ``weighted_mean`` instead of the aggregator (no
on-aggregation defense), some run their own loop (no ``_poisoned_copy``,
no before-stage hooks), and decentralized FL runs no server hook at all.
Read from the JAX code, the member x hook table is (yes: runs; no: the JAX
twin skips it silently, and the port refuses it when the object is built,
naming the member and the hook; ``SKIPPED_HOOKS`` of each class):

================  =====  ======  ======  ======  ======  =====  =====
member            model  data    before  on      after   local  cen-
                  attack poison  defense defense defense DP     tral DP
================  =====  ======  ======  ======  ======  =====  =====
FedAvg, FedProx   yes    yes     yes     yes     yes     yes    yes
FedOpt            yes    yes     yes     no      yes     yes    yes
FedNova           yes(1) yes     yes(1)  no      yes     yes    yes
FedSGD            yes    yes     yes     no      yes     no     yes
SCAFFOLD          yes    yes     yes     yes     yes     no     yes
FedDyn            yes    yes     yes     no      yes     no     yes
AsyncFedAvg       no     no      no      no      yes     yes    yes
FedBuff (async)   yes(2) no      yes     yes     yes     yes    yes
HierarchicalFL    no     no      no      no      yes(3)  yes    yes(3)
decentralized     no     no      no      no      no      yes    no
SpreadGNN         no     no      no      no      no      yes    no
Turbo-Aggregate   no     yes     no      no      yes     yes    yes
FedSeg            no     no      no      no      no      no     no
FedGAN            no     no      no      no      no      no     no
FedNAS            no     no      no      no      no      no     no
FedGKT            no     no      no      no      no      no     no
split NN          no     no      no      no      no      no     no
vertical FL       no     no      no      no      no      no     no
================  =====  ======  ======  ======  ======  =====  =====

(1) FedNova pairs each tau with its update by object identity before the
before-stage hooks: an update they keep as it is (krum, multi-krum) keeps
its tau, one they rebuild (norm clipping, a model attack) takes tau 1.0,
as in the JAX package.  (2) FedBuff never tells the attacker the flush's
clients, so a model attack picks its malicious updates by position in the
flush, as the JAX twin does.  (3) HierarchicalFL runs the
after-aggregation hooks at each global average only (every
``group_comm_round`` rounds).  Turbo-Aggregate's data poisoning runs
through ``FedAvgAPI``'s round loop, which it keeps.

The in-mesh rounds under ``backend: XLA`` (``simulation/xla``) refuse by
the same rule: the gossip, FedGAN, FedNAS, vertical FL, split NN and FedGKT
rounds every hook; the hierarchical and Turbo-Aggregate rounds all but the
after-aggregation defense and central DP, which their JAX twins run.
"""

from __future__ import annotations

import importlib

# lower-cased optimizer -> (module under simulation/sp, class); JAX's _dispatch
_MEMBERS = {
    "fedavg": ("fedavg.fedavg_api", "FedAvgAPI"),
    "fedopt": ("fedopt.fedopt_api", "FedOptAPI"),
    "fedprox": ("fedprox.fedprox_api", "FedProxAPI"),
    "fednova": ("fednova.fednova_api", "FedNovaAPI"),
    "fedsgd": ("fedsgd.fedsgd_api", "FedSGDAPI"),
    "scaffold": ("scaffold.scaffold_api", "ScaffoldAPI"),
    "feddyn": ("feddyn.feddyn_api", "FedDynAPI"),
    "hierarchicalfl": ("hierarchical_fl.hier_api", "HierarchicalFLAPI"),
    "decentralized_fl": ("decentralized.decentralized_api", "DecentralizedFLAPI"),
    "turbo_aggregate": ("turboaggregate.ta_api", "TurboAggregateAPI"),
    "spreadgnn": ("spreadgnn.spreadgnn_api", "SpreadGNNAPI"),
    "async_fedavg": ("async_fedavg.async_fedavg_api", "AsyncFedAvgAPI"),
    "classical_vertical": ("classical_vertical_fl.vfl_api", "VerticalFLAPI"),
    "split_nn": ("split_nn.split_nn_api", "SplitNNAPI"),
    "fedgan": ("fedgan.fedgan_api", "FedGanAPI"),
    "fedgkt": ("fedgkt.gkt_api", "FedGKTAPI"),
    "fednas": ("fednas.fednas_api", "FedNASAPI"),
    "fedseg": ("fedseg.fedseg_api", "FedSegAPI"),
}
_FEDBUFF = ("async_fedavg.fedbuff_api", "FedBuffAPI")


def create_sp_algorithm(optimizer: str, args, device, dataset, model):
    opt = optimizer.lower()
    if str(getattr(args, "fl_mode", "sync") or "sync").lower() == "async":
        # buffered-async execution replaces the round loop; only the FedAvg
        # rule has an async counterpart
        if opt != "fedavg":
            raise ValueError(
                f"fl_mode=async supports federated_optimizer 'fedavg' only "
                f"in the sp simulator (got {optimizer!r})")
        member = _FEDBUFF
    elif opt in _MEMBERS:
        member = _MEMBERS[opt]
    else:
        raise ValueError(f"unknown federated_optimizer {optimizer!r}")
    module = importlib.import_module(f"{__name__}.{member[0]}")
    return getattr(module, member[1])(args, device, dataset, model)
