"""Single-process FedAvg simulator of the port (counterpart of
``fedml_tpu/simulation/sp/fedavg/fedavg_api.py``: ``Client``, ``FedAvgAPI``).

Each round draws its cohort through the population manager (the uniform
``mt19937`` schedule, the JAX package's clients), re-binds
``client_num_per_round`` client slots to the sampled clients' data, and
trains them one after another through the one client trainer
(``ml/trainer``: the engine's local training on the client's data, moved to
the trainer's device, padded to its bucket).  The server step runs the
``ServerAggregator`` hooks where the JAX package runs them: model attacks and
the defender's filtering (``on_before_aggregation``), the defended or
sample-weighted aggregate (``aggregate``), the defender's post-processing and
central DP (``on_after_aggregation``).  Data-poisoning attacks transform a
malicious client's data for its round (``_poisoned_copy``); local DP noises
each client's variables in the trainer's after-hook.  The global model is
evaluated at ``round_idx % frequency_of_the_test == 0`` and after the last
round.  On the card the rounds run with fp32 products in full fp32 (TF32
off), the flags set back when ``train`` returns.

The zoo members (``simulation/sp/*``) subclass ``FedAvgAPI``: the override
points are ``_train_client`` (one client's training in its slot),
``_local_updates``, ``server_update``, ``_client_sampling`` and ``_train``
(the whole loop, inside the fp32 pin).  A member whose JAX twin skips one of
the trust hooks names it in ``SKIPPED_HOOKS`` and is refused at construction
when that hook is on (``active_hooks``; the table is in
``simulation/sp/__init__.py``).

Not ported: checkpointing, the obs spans and telemetry, and the population's
round accounting (ROADMAP.md queue A, items 9b, 9d and 9c); their knobs
raise.  ``frequency_of_the_test: 0``, which the JAX round divides by, is
refused when the object is built.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ....core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
from ....core.population import PopulationManager
from ....core.security.constants import ATTACK_METHOD_EDGE_CASE_BACKDOOR
from ....core.security.fedml_attacker import ANALYSIS_REFUSAL, FedMLAttacker
from ....core.security.fedml_defender import _BEFORE_DEFENSES, _ON_DEFENSES, FedMLDefender
from ....device import fp32_matmul
from ....ml.aggregator.aggregator_creator import create_server_aggregator
from ....ml.engine.train import init_variables, load_variables
from ....ml.trainer.cls_trainer import to_device
from ....ml.trainer.trainer_creator import create_model_trainer
from ....utils.metrics import MetricsLogger
from ...xla.fed_sim import XLA_ROUND_KNOBS, refuse_unported_knobs

logger = logging.getLogger(__name__)

# the trust hooks of an sp round, by the names the zoo's refusals give them
MODEL_ATTACK, DATA_POISONING = "model attack", "data poisoning"
BEFORE_DEFENSE, ON_DEFENSE, AFTER_DEFENSE = (
    "before-aggregation defense", "on-aggregation defense", "after-aggregation defense")
LOCAL_DP, CENTRAL_DP = "local DP", "central DP"


def active_hooks() -> set:
    """The trust hooks the attacker, defender and DP singletons switch on."""
    attacker = FedMLAttacker.get_instance()
    defender = FedMLDefender.get_instance()
    dp = FedMLDifferentialPrivacy.get_instance()
    on = set()
    if attacker.is_model_attack():
        on.add(MODEL_ATTACK)
    if attacker.is_data_poisoning_attack():
        on.add(DATA_POISONING)
    if defender.is_defense_enabled():
        on.add(BEFORE_DEFENSE if defender.defense_type in _BEFORE_DEFENSES
               else ON_DEFENSE if defender.defense_type in _ON_DEFENSES else AFTER_DEFENSE)
    if dp.is_local_dp_enabled():
        on.add(LOCAL_DP)
    if dp.is_global_dp_enabled():
        on.add(CENTRAL_DP)
    return on


def own_loop_setup(args, member: str, frequency: bool = True, skip=XLA_ROUND_KNOBS) -> int:
    """The checks of a member that runs a loop of its own (FedSeg, the
    structural members, the in-mesh FedGAN, FedNAS, vertical FL, split NN and
    FedGKT rounds): the unported knobs refused (less ``skip``), every trust
    hook switched on refused (the JAX twin skips them all silently; the table
    is in ``simulation/sp/__init__.py``), and, where the member reads it,
    ``frequency_of_the_test`` returned, refused at 0 or below (else 0)."""
    refuse_unported_knobs(args, skip=skip)
    on = active_hooks()
    attacker = FedMLAttacker.get_instance()
    if attacker.is_attack_enabled():
        on.add(f"{attacker.attack_type} attack")
    if on:
        raise NotImplementedError(
            f"{member} does not run the {' or the '.join(sorted(on))} hook (its JAX twin "
            "skips it silently; the table is in simulation/sp/__init__.py)")
    if not frequency:
        return 0
    freq = int(getattr(args, "frequency_of_the_test", 5))
    if freq <= 0:
        raise ValueError(
            f"frequency_of_the_test must be >= 1 for the sp simulator (got {freq}): "
            "the round tests the global model at round_idx % frequency_of_the_test == 0")
    return freq


class Client:
    """A reusable client slot."""

    def __init__(self, client_idx, local_training_data, local_test_data, local_sample_number,
                 args, trainer):
        self.client_idx = client_idx
        self.local_training_data = local_training_data
        self.local_test_data = local_test_data
        self.local_sample_number = local_sample_number
        self.args = args
        self.trainer = trainer

    def update_local_dataset(self, client_idx, local_training_data, local_test_data,
                             local_sample_number):
        self.client_idx = client_idx
        self.local_training_data = local_training_data
        self.local_test_data = local_test_data
        self.local_sample_number = local_sample_number
        self.trainer.set_id(client_idx)

    def train(self, w_global):
        self.trainer.set_model_params(w_global)
        self.trainer.on_before_local_training(self.local_training_data, None, self.args)
        self.trainer.train(self.local_training_data, None, self.args)
        self.trainer.on_after_local_training(self.local_training_data, None, self.args)
        return self.trainer.get_model_params()

    def local_test(self, use_test_set: bool):
        data = self.local_test_data if use_test_set else self.local_training_data
        return self.trainer.test(data, None, self.args)


class FedAvgAPI:
    # the trust hooks this member's JAX twin silently skips: refused when on
    SKIPPED_HOOKS: tuple = ()

    def __init__(self, args, device, dataset, model):
        self.args = args
        self.device = torch.device(device)
        (
            self.train_global_num,
            self.test_global_num,
            self.train_data_global,
            self.test_data_global,
            self.train_data_local_num_dict,
            self.train_data_local_dict,
            self.test_data_local_dict,
            self.class_num,
        ) = dataset
        refuse_unported_knobs(args, skip=XLA_ROUND_KNOBS)
        self.freq = self._frequency(args)
        attacker = FedMLAttacker.get_instance()
        if attacker.is_analysis_attack():
            raise NotImplementedError(ANALYSIS_REFUSAL)
        if (attacker.is_attack_enabled() and not attacker.is_model_attack()
                and not attacker.is_data_poisoning_attack()):
            raise NotImplementedError(
                f"attack_type {attacker.attack_type!r} has no sp-simulator hook")
        on = active_hooks()
        skipped = [h for h in self.SKIPPED_HOOKS if h in on]
        if skipped:
            raise NotImplementedError(
                f"{type(self).__name__} does not run the {' or the '.join(skipped)} hook "
                "(its JAX twin skips it silently; the table is in simulation/sp/__init__.py)")
        self.module = model
        self.w_global = init_variables(model, self.device,
                                       seed=int(getattr(args, "random_seed", 0)))

        self.trainer = create_model_trainer(model, args)
        self.aggregator = create_server_aggregator(model, args)
        self.aggregator.set_model_params(self.w_global)

        self.client_list: List[Client] = []
        self._setup_clients()
        self.metrics = MetricsLogger(args)
        self.round_times: List[float] = []
        self.samples_per_round: List[int] = []
        self.population = PopulationManager.from_args(
            self.args, np.arange(int(self.args.client_num_in_total)), rng_style="mt19937")

    def _frequency(self, args) -> int:
        freq = int(getattr(args, "frequency_of_the_test", 5))
        if freq <= 0:
            raise ValueError(
                f"frequency_of_the_test must be >= 1 for the sp simulator (got {freq}): "
                "the round tests the global model at round_idx % frequency_of_the_test == 0")
        return freq

    def _eval_due(self, round_idx: int, comm_round: int) -> bool:
        """Whether the global model is tested after ``round_idx`` (never when
        ``freq`` is 0)."""
        return self.freq > 0 and (round_idx % self.freq == 0 or round_idx == comm_round - 1)

    def _setup_clients(self):
        for client_idx in range(int(self.args.client_num_per_round)):
            self.client_list.append(Client(
                client_idx,
                self.train_data_local_dict[client_idx],
                self.test_data_local_dict[client_idx],
                self.train_data_local_num_dict[client_idx],
                self.args,
                self.trainer,
            ))

    def _client_sampling(self, round_idx: int) -> List[int]:
        return [int(c) for c in self.population.select(
            round_idx, int(self.args.client_num_per_round))]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self) -> Dict[str, Any]:
        with fp32_matmul():
            return self._train()

    def _train(self) -> Dict[str, Any]:
        comm_round = int(self.args.comm_round)
        last_metrics: Dict[str, Any] = {}
        for round_idx in range(comm_round):
            t0 = time.time()
            client_indexes = self._client_sampling(round_idx)
            logger.info("round %d: clients %s", round_idx, client_indexes)
            w_locals = self._local_updates(round_idx, client_indexes)
            self.samples_per_round.append(
                int(sum(n for n, _ in w_locals)) * int(getattr(self.args, "epochs", 1)))

            self.w_global = self.server_update(w_locals)
            self.aggregator.set_model_params(self.w_global)
            self._sync()
            dt = time.time() - t0
            self.round_times.append(dt)
            self.metrics.log({"round": round_idx, "round_time_s": round(dt, 4)})
            if self._eval_due(round_idx, comm_round):
                last_metrics = self._test_global(round_idx)
        return last_metrics

    def _local_updates(self, round_idx: int, client_indexes: List[int]) -> List[Tuple[float, Any]]:
        """Train the round's clients from the global model, one after another
        in their slots: their ``(sample count, variables)`` in cohort order."""
        self.trainer.round_idx = round_idx  # the round's seed of the shuffles
        w_locals: List[Tuple[float, Any]] = []
        attacker = FedMLAttacker.get_instance()
        if attacker.is_attack_enabled():
            # the model attack corrupts the population clients the data
            # poisoning targets (slots differ under sampling)
            attacker.set_round_clients(client_indexes)
        for slot, idx in enumerate(client_indexes):
            client = self.client_list[slot]
            local_data = self.train_data_local_dict[idx]
            if attacker.is_data_poisoning_attack():
                local_data = self._poisoned_copy(idx, local_data, attacker)
            client.update_local_dataset(
                idx,
                local_data,
                self.test_data_local_dict[idx],
                self.train_data_local_num_dict[idx],
            )
            w = self._train_client(client, self.w_global)
            w_locals.append((float(client.local_sample_number), w))
        return w_locals

    def _train_client(self, client: Client, w_global) -> Any:
        """One client's training from ``w_global`` in its slot: what it
        uploads (FedAvg: its variables)."""
        return client.train(w_global)

    def _poisoned_copy(self, client_idx: int, local_data, attacker) -> Any:
        """A malicious client's data for its round, transformed by the data
        attack (the clean dict is never mutated); benign clients' data are
        returned as they are.  The edge-case backdoor selects by the current
        global model's logits."""
        num_total = int(self.args.client_num_in_total)
        if int(client_idx) not in set(attacker.get_byzantine_idxs(num_total)):
            return local_data  # benign: skip (and skip the forward pass)
        x, y = local_data
        logits = None
        if attacker.attack_type == ATTACK_METHOD_EDGE_CASE_BACKDOOR:
            load_variables(self.module, self.w_global)
            self.module.eval()
            with torch.no_grad():
                logits = self.module(to_device(x, self.device)).float().cpu().numpy()
        return attacker.poison_local_data(client_idx, num_total, x, y, logits=logits)

    def server_update(self, w_locals: List[Tuple[float, Any]]) -> Any:
        """The aggregation step with the hooks where the JAX package runs
        them; the override point of the algorithm zoo."""
        w_locals = self.aggregator.on_before_aggregation(w_locals)
        w_global = self.aggregator.aggregate(w_locals)
        return self.aggregator.on_after_aggregation(w_global)

    def _test_global(self, round_idx: int) -> Dict[str, Any]:
        stats = self.aggregator.test(self.test_data_global, self.device, self.args)
        acc = stats["test_correct"] / stats["test_total"]
        loss = stats["test_loss"] / stats["test_total"]
        out = {"round": round_idx, "test_acc": round(float(acc), 4),
               "test_loss": round(float(loss), 4)}
        # task-specific extras pass through
        for k, v in stats.items():
            if k.startswith("test_") and k not in ("test_correct", "test_total", "test_loss"):
                out[k] = round(float(v), 4)
        self.metrics.log(out)
        logger.info("eval: %s", out)
        return out
