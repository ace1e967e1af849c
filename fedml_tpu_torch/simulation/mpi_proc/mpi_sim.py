"""Multi-process simulation, one OS process a rank (counterpart of
``fedml_tpu/simulation/mpi_proc/mpi_sim.py``, the reference's ``mpirun -np
N`` workflow).

Each rank is a process joined to the others through the TCP
:class:`~fedml_tpu_torch.core.distributed.collective.ProcessGroup` (rank 0
the hub).  Every round each rank takes the strided share
``client_sampling(round)[rank::world]`` of the round's clients, trains them
one after another through the ``ClientTrainer`` hook contract on its own
device, and sums their ``n_i``-weighted fp32 params; one weighted
allreduce-mean of the ranks' local means gives the new global model, which
equals the single-process FedAvg aggregate up to the order of the sums.
Rank 0 owns the round-0 init, broadcast to every rank, noises the aggregate
when central DP is on (then broadcast, so every rank holds the same noised
model) and evaluates.

Every rank runs on the card that ``device.get_device`` gives it (on one H100
all ranks open their own context on ``cuda:0``), or on the CPU when the
config sets ``device_args.device_type: cpu``.  Ranks are started with the
``spawn`` method: CUDA does not survive a fork, and ``run_mpi_simulation``
itself never touches the card.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Tuple

import torch

from ...core.distributed.collective import ProcessGroup
from ...core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
from ...core.sampling import client_sampling
from ...core.security.fedml_attacker import FedMLAttacker
from ...core.security.fedml_defender import FedMLDefender
from ...device import fp32_matmul, get_device
from ...ml.aggregator.aggregator_creator import create_server_aggregator
from ...ml.engine.train import init_variables
from ...ml.trainer.trainer_creator import create_model_trainer
from ...utils.metrics import MetricsLogger
from ..xla.fed_sim import refuse_unported_knobs

logger = logging.getLogger(__name__)


def _materialise(module: torch.nn.Module, device: torch.device) -> None:
    """A module built on the ``meta`` device, given storage on ``device``
    (its values come from the broadcast init)."""
    if any(p.is_meta for p in module.parameters()):
        module.to_empty(device=device)
    module.to(device)


class MPIProcessSimulator:
    """One rank of the multi-process round.  ``args`` carries ``mpi_rank``,
    ``mpi_world_size`` and the hub's ``pg_master_address`` /
    ``pg_master_port`` (with ``pg_token``, ``pg_timeout`` and
    ``pg_op_timeout``)."""

    def __init__(self, args, dataset, model, client_trainer=None):
        self.args = args
        (
            self.train_num, _test_num, train_global, self.test_global,
            self.local_num_dict, self.local_train_dict, _lt, self.class_num,
        ) = dataset
        self.rank = int(getattr(args, "mpi_rank", 0))
        self.world = int(getattr(args, "mpi_world_size", 1))
        # the weighted-mean family only (FedAvg, and FedProx through the
        # engine's proximal hook); the zoo and the trust hooks ride sp or XLA
        opt = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
        if opt not in ("fedavg", "fedprox"):
            raise NotImplementedError(
                f"backend MPI_PROC supports FedAvg/FedProx, not {opt!r}; "
                "use backend 'sp' or 'XLA' for the algorithm zoo")
        if (FedMLAttacker.get_instance().is_attack_enabled()
                or FedMLDefender.get_instance().is_defense_enabled()):
            raise NotImplementedError(
                "backend MPI_PROC has no attack/defense hooks; use 'sp' or 'XLA'")
        refuse_unported_knobs(args)
        self.device = get_device(args)
        addr = (str(getattr(args, "pg_master_address", "127.0.0.1")),
                int(getattr(args, "pg_master_port", 29600)))
        token = str(getattr(args, "pg_token", None) or f"{getattr(args, 'run_id', '0')}-mpi")
        t0 = time.perf_counter()
        self.pg = ProcessGroup(
            self.rank, self.world, addr=addr, token=token,
            timeout=float(getattr(args, "pg_timeout", 60.0)),
            op_timeout=float(getattr(args, "pg_op_timeout", 1800.0)),
            device=self.device)
        self.rendezvous_s = time.perf_counter() - t0
        self.module = model
        self.trainer = client_trainer if client_trainer is not None else \
            create_model_trainer(model, args)
        if self.rank == 0 and self.trainer.get_model_params() is None:
            # rank 0 owns the round-0 init it broadcasts
            self.trainer.set_model_params(init_variables(
                model, self.device, seed=int(getattr(args, "random_seed", 0))))
        else:
            _materialise(model, self.device)
        self.aggregator = create_server_aggregator(model, args)
        self.metrics = MetricsLogger(args)
        self.round_times: List[float] = []

    def train(self) -> Dict[str, Any]:
        with fp32_matmul():
            return self._train()

    def _train(self) -> Dict[str, Any]:
        args = self.args
        comm_round = int(args.comm_round)
        cpr = int(args.client_num_per_round)
        n_total = int(args.client_num_in_total)
        freq = int(getattr(args, "frequency_of_the_test", 10))
        # rank 0's init is every rank's round-0 model
        params = self.pg.broadcast(self.trainer.get_model_params() if self.rank == 0 else None)
        dtypes = {k: v.dtype for k, v in params.items()}
        last: Dict[str, Any] = {}
        for round_idx in range(comm_round):
            t0 = time.perf_counter()
            # the uniform client_sampling seam: every rank derives the same
            # schedule from round_idx alone
            sampled = client_sampling(round_idx, n_total, cpr)
            mine = [int(c) for c in sampled[self.rank::self.world]]
            acc = None
            n_sum = 0.0
            for cid in mine:
                x, y = self.local_train_dict[cid]
                n_i = int(self.local_num_dict[cid])
                if n_i <= 0:
                    continue
                self.trainer.set_model_params(params)
                self.trainer.set_id(cid)
                self.trainer.round_idx = round_idx
                # the full hook contract: local DP is drawn in the after-hook
                self.trainer.on_before_local_training((x, y), None, args)
                self.trainer.train((x, y), None, args)
                self.trainer.on_after_local_training((x, y), None, args)
                with torch.no_grad():
                    w_i = {k: v.float() * n_i for k, v in self.trainer.get_model_params().items()}
                    acc = w_i if acc is None else {k: acc[k].add_(w_i[k]) for k in acc}
                n_sum += n_i
            with torch.no_grad():
                if acc is None:  # more ranks than sampled clients this round
                    local_mean = {k: torch.zeros_like(v, dtype=torch.float32)
                                  for k, v in params.items()}
                else:
                    local_mean = {k: v / n_sum for k, v in acc.items()}
            # every rank learns the round's total weight first (the same value
            # everywhere, so the branch stays collective); an empty round
            # keeps the previous model
            w_tot = float(self.pg.allreduce_sum(torch.tensor(n_sum, dtype=torch.float64)))
            if w_tot > 0:
                mean = self.pg.allreduce_mean(local_mean, weight=n_sum)
                params = self._central_dp({k: v.to(dtypes[k]) for k, v in mean.items()})
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.round_times.append(time.perf_counter() - t0)
            if self.rank == 0 and freq > 0 and (
                    round_idx % freq == 0 or round_idx == comm_round - 1):
                self.aggregator.set_model_params(params)
                stats = self.aggregator.test(self.test_global, self.device, args)
                last = {
                    "round": round_idx,
                    "test_acc": round(stats["test_correct"] / stats["test_total"], 4),
                    "test_loss": round(stats["test_loss"] / stats["test_total"], 4),
                }
                self.metrics.log(last)
                logger.info("mpi_proc eval: %s", last)
        self.trainer.set_model_params(params)
        self.pg.barrier()
        self.pg.close()
        return last

    def _central_dp(self, params):
        """Central DP on the aggregate: rank 0 noises, then broadcasts, so
        every rank carries the same noised global."""
        dp = FedMLDifferentialPrivacy.get_instance()
        if not dp.is_global_dp_enabled():
            return params
        if self.rank == 0:
            params = dp.add_global_noise(params)
        return self.pg.broadcast(params if self.rank == 0 else None)

    def run(self) -> Dict[str, Any]:
        return self.train()


def _rank_entry(cfg: Dict[str, Any], rank: int, world: int, port: int, q, joined) -> None:
    """A rank process's entry: rebuild args, data and model from the config
    dict (spawn-safe) and run one rank.  ``joined`` is set once this rank's
    rendezvous succeeded; the parent's retry keys on it.  Puts (rank, final
    metrics, {"rendezvous_s", "round_s"})."""
    import fedml_tpu_torch
    from ...arguments import Arguments

    args = fedml_tpu_torch.init(Arguments.from_dict(cfg).validate(), should_init_logs=False)
    args.mpi_rank = rank
    args.mpi_world_size = world
    args.pg_master_port = port
    dataset, out_dim = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, out_dim)
    sim = MPIProcessSimulator(args, dataset, model)  # the group joins in here
    joined.set()
    metrics = sim.train()
    q.put((rank, metrics, {"rendezvous_s": sim.rendezvous_s, "round_s": sim.round_times}))


class _RanksDiedError(RuntimeError):
    def __init__(self, msg: str, rendezvous_done: bool):
        super().__init__(msg)
        self.rendezvous_done = rendezvous_done


def run_mpi_simulation(config: Dict[str, Any], world_size: int, port: int = 0,
                       deadline_s: float = 3600.0, retries: int = 2) -> Dict[str, Any]:
    """The ``mpirun -np N`` replacement: spawn ``world_size`` rank processes
    from one nested config dict and return rank 0's final metrics; each
    rank's rendezvous and round seconds are logged.

    ``deadline_s`` bounds the whole run; per-collective timeouts come from the
    config's ``pg_timeout`` / ``pg_op_timeout``.  An auto-picked port
    (``port=0``) is probed and released, which races other processes on the
    host, so a rendezvous that fails retries on a fresh port up to
    ``retries`` times; pass a reserved ``port`` for a fixed placement."""
    for attempt in range(int(retries) + 1):
        try:
            results = _run_once(config, world_size, port, deadline_s)
            break
        except _RanksDiedError as e:
            # only a crash before every rank joined smells like a port race;
            # a world that died mid-training is a real failure
            if attempt == retries or port != 0 or e.rendezvous_done:
                raise
            logger.warning("mpi ranks died during rendezvous (possible port race); "
                           "retrying on a fresh port")
    for rank in sorted(results):
        timing = results[rank][1]
        logger.info("mpi rank %d of %d: rendezvous %.3f s, rounds %s s", rank, world_size,
                    timing["rendezvous_s"], [round(t, 4) for t in timing["round_s"]])
    return results[0][0] if 0 in results else {}


def _run_once(config: Dict[str, Any], world_size: int, port: int,
              deadline_s: float) -> Dict[int, Tuple[Dict[str, Any], Dict[str, Any]]]:
    """One spawned world: {rank: (final metrics, timing)}."""
    import multiprocessing as mp
    import queue as _queue
    import socket

    if port == 0:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    joined = [ctx.Event() for _ in range(world_size)]
    procs = [ctx.Process(target=_rank_entry, args=(config, r, world_size, port, q, joined[r]))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results: Dict[int, Tuple[Dict[str, Any], Dict[str, Any]]] = {}
    deadline = time.time() + float(deadline_s)
    try:
        while len(results) < world_size:
            try:
                rank, metrics, timing = q.get(timeout=5)
                results[rank] = (metrics, timing)
            except _queue.Empty:
                dead = [p.exitcode for p in procs
                        if not p.is_alive() and p.exitcode not in (0, None)]
                if dead:
                    # fail fast on a crashed rank instead of starving on the
                    # queue until the deadline
                    raise _RanksDiedError(f"mpi rank process(es) died: {dead}",
                                          rendezvous_done=all(e.is_set() for e in joined))
                if time.time() > deadline:
                    raise TimeoutError("mpi simulation timed out")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return results
