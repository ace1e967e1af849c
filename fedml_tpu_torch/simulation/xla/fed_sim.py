"""The port's round simulator: the padded round of
``fedml_tpu/simulation/xla/fed_sim.py`` (``XLASimulator``) on one CUDA card.

The JAX simulator compiles a round into one XLA program over a device mesh:
the sampled clients are sharded over a ``client`` axis, each device scans
its clients through the compiled local-training engine, and a ``psum``
reduces the weighted sums.  On one card the ``client`` axis and its ``psum``
become a loop over the sampled clients, in cohort order:

* the whole dataset is uploaded once (``_pack_data``) with a per-client
  index table padded to ``padded_n`` rows, so a client's data is one
  on-device gather;
* each client trains from the round's global variables
  (``ml.engine.train.build_local_train``) and adds ``n_i * variables`` into an
  fp32 accumulator;
* the algorithm's server step turns the accumulator into the next global
  variables.

The cohort of each round is the population manager's ``mt19937`` draw, the
same clients as the JAX package picks.  Knobs of subsystems the port does not
have yet raise ``NotImplementedError`` when set; none is ignored.

The class keeps the JAX name so a reader finds its counterpart.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ...core.population import PopulationManager
from ...ml.aggregator.aggregator_creator import create_server_aggregator
from ...ml.engine.train import build_local_train, init_variables
from ...ml.trainer.trainer_creator import _TAG_DATASETS, loss_kind_for_dataset
from ...utils.metrics import MetricsLogger
from .algorithms import create_inmesh_algorithm

logger = logging.getLogger(__name__)


def _is_set(args, key: str) -> bool:
    v = getattr(args, key, None)
    if isinstance(v, str):
        return v.strip().lower() not in ("", "0", "false", "off", "no", "none")
    return bool(v)


# (knob, is it switched on?, the ROADMAP.md item that ports it)
_UNPORTED_KNOBS = (
    ("enable_attack", _is_set, "queue A, item 12: core/security"),
    ("enable_defense", _is_set, "queue A, item 12: core/security"),
    ("enable_dp", _is_set, "queue A, item 12: core/dp"),
    ("xla_pack", _is_set, "queue A, item 6: packed simulator"),
    ("xla_client_chunk", _is_set, "queue A, item 6: packed simulator"),
    ("population_stacked", _is_set, "queue A, item 6: population"),
    ("fl_mode", lambda a, k: str(getattr(a, k, "sync") or "sync").lower() != "sync",
     "queue A, item 12: async algorithms"),
    ("server_state", lambda a, k: str(getattr(a, k, "replicated") or "replicated").lower()
     != "replicated", "queue A, item 15: server planes"),
    ("agg_plane", lambda a, k: str(getattr(a, k, "host") or "host").lower() != "host",
     "queue A, item 15: server planes"),
    ("checkpoint_dir", _is_set, "queue A, item 16: checkpointing"),
    ("proximal_mu", lambda a, k: float(getattr(a, k, 0) or 0) > 0,
     "queue A, item 12: FedProx grad hook"),
    ("obs_trace", _is_set, "queue A, item 16: obs/telemetry"),
    ("obs_telemetry", _is_set, "queue A, item 16: obs/telemetry"),
    ("obs_health", _is_set, "queue A, item 16: obs/telemetry"),
    ("enable_profiler", _is_set, "queue A, item 16: obs/telemetry"),
)


def refuse_unported_knobs(args) -> None:
    for key, on, item in _UNPORTED_KNOBS:
        if on(args, key):
            raise NotImplementedError(
                f"{key}={getattr(args, key)!r} is not ported to the torch simulator yet "
                f"(ROADMAP.md {item})")


def pin_fp32_matmul() -> Dict[str, bool]:
    """fp32 products in full fp32, never TF32, on the card; returns the flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}


class XLASimulator:
    def __init__(self, args, dataset, model, device: torch.device):
        self.args = args
        (
            self.train_num,
            self.test_num,
            self.train_global,
            self.test_global,
            self.local_num_dict,
            self.local_train_dict,
            _local_test_dict,
            self.class_num,
        ) = dataset
        refuse_unported_knobs(args)
        self.module = model
        self.device = torch.device(device)
        if self.device.type == "cuda":
            logger.info("tf32 flags %s", pin_fp32_matmul())

        self.num_clients = int(args.client_num_in_total)
        self.clients_per_round = int(args.client_num_per_round)
        self.batch_size = int(getattr(args, "batch_size", 32))
        self.epochs = int(getattr(args, "epochs", 1))
        ds = str(getattr(args, "dataset", "")).lower()
        if ds in _TAG_DATASETS:
            raise NotImplementedError(
                f"dataset {ds!r} (multi-hot labels) is not ported yet (ROADMAP.md queue A, item 14)")
        self.loss_kind = loss_kind_for_dataset(ds)

        self._pack_data()
        self.variables = init_variables(model, self.device,
                                        seed=int(getattr(args, "random_seed", 0)))
        self.algo = create_inmesh_algorithm(args)
        self.server_state = self.algo.init_server_state(self.variables)
        self._local_train = build_local_train(
            self.module, self.args, self.batch_size, self.padded_n, loss=self.loss_kind)
        self.population = PopulationManager.from_args(
            self.args, np.arange(self.num_clients), rng_style="mt19937")
        self.aggregator = create_server_aggregator(model, args)
        self.metrics = MetricsLogger(args)
        self.round_times: List[float] = []
        self.round_losses: List[float] = []
        self.samples_per_round: List[int] = []
        self.samples_trained = 0

    # ------------------------------------------------------------------
    # data packing: one device-resident array + per-client index table
    # ------------------------------------------------------------------
    def _pack_data(self):
        """Concatenate client shards into one device-resident array pair and
        record each client's contiguous row range in an index table padded to
        ``padded_n`` (padding rows repeat the client's first row and are
        masked out by its count).  Integer inputs (token ids) keep their
        dtype."""
        b = self.batch_size
        counts = np.array([self.local_num_dict[i] for i in range(self.num_clients)], np.int64)
        self.max_client_n = int(counts.max())
        self.padded_n = max(b, -(-self.max_client_n // b) * b)
        xs, ys = [], []
        idx = np.zeros((self.num_clients, self.padded_n), np.int64)
        cursor = 0
        for i in range(self.num_clients):
            xi, yi = self.local_train_dict[i]
            n = len(yi)
            xs.append(np.asarray(xi))
            ys.append(np.asarray(yi))
            if n > 0:
                idx[i, :n] = np.arange(cursor, cursor + n)
                idx[i, n:] = cursor
            cursor += n
        self.client_counts = counts
        self.client_idx = torch.from_numpy(idx).to(self.device)
        self.x_all = torch.from_numpy(np.concatenate(xs, 0)).to(self.device)
        self.y_all = torch.from_numpy(np.concatenate(ys, 0)).to(self.device)
        logger.info("packed %d clients (max_n=%d padded_n=%d) data %s (%s) onto %s",
                    self.num_clients, self.max_client_n, self.padded_n,
                    tuple(self.x_all.shape), self.x_all.dtype, self.device)

    def _client_sampling(self, round_idx: int) -> np.ndarray:
        return np.asarray(self.population.select(round_idx, self.clients_per_round), np.int64)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_round(self, round_idx: int, sampled: np.ndarray):
        """Train the cohort from the current global variables and apply the
        server step.  Returns (mean loss tensor, per-client sample counts)."""
        counts = self.client_counts[sampled]
        acc = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in self.variables.items()}
        wsum = 0.0
        lsum = torch.zeros((), dtype=torch.float32, device=self.device)
        seed = int(getattr(self.args, "random_seed", 0))
        for cid, n_i in zip(sampled.tolist(), counts.tolist()):
            if n_i <= 0:
                continue  # contributes nothing, as a weight-0 slot in the mesh round
            rows = self.client_idx[cid]
            result = self._local_train(self.variables, self.x_all.index_select(0, rows),
                                       self.y_all.index_select(0, rows), n_i,
                                       seed=(seed, round_idx, cid))
            for k, p in result.variables.items():
                acc[k].add_(p.float(), alpha=float(n_i))
            wsum += float(n_i)
            lsum += result.loss * float(n_i)
        mean_loss = lsum / max(wsum, 1e-9)
        self.variables, self.server_state = self.algo.server_update(
            acc, wsum, self.variables, self.server_state)
        return mean_loss, counts

    def train(self) -> Dict[str, Any]:
        comm_round = int(self.args.comm_round)
        freq = int(getattr(self.args, "frequency_of_the_test", 10))
        last: Dict[str, Any] = {}
        for round_idx in range(comm_round):
            t0 = time.time()
            sampled = self._client_sampling(round_idx)
            mean_loss, counts = self._run_round(round_idx, sampled)
            self._sync()
            dt = time.time() - t0
            self.round_times.append(dt)
            self.samples_per_round.append(int(counts.sum()) * self.epochs)
            self.samples_trained += int(counts.sum()) * self.epochs
            self.round_losses.append(float(mean_loss))
            self.metrics.log({"round": round_idx, "round_time_s": round(dt, 4),
                              "train_loss": self.round_losses[-1]})
            if freq > 0 and (round_idx % freq == 0 or round_idx == comm_round - 1):
                last = self._test_global(round_idx)
        return last

    def _test_global(self, round_idx: int) -> Dict[str, Any]:
        self.aggregator.set_model_params(self.variables)
        stats = self.aggregator.test(self.test_global, self.device, self.args)
        out = {
            "round": round_idx,
            "test_acc": round(stats["test_correct"] / stats["test_total"], 4),
            "test_loss": round(stats["test_loss"] / stats["test_total"], 4),
        }
        self.metrics.log(out)
        logger.info("eval: %s", out)
        return out

    def throughput(self) -> Dict[str, float]:
        """Steady-state throughput: medians over the rounds after the first
        (which pays the kernels' build and first launches).  With token data,
        ``tokens_per_sec`` counts input tokens.  All zeros if no round ran."""
        times = self.round_times[1:] if len(self.round_times) > 1 else self.round_times
        samples = (self.samples_per_round[1:] if len(self.samples_per_round) > 1
                   else self.samples_per_round)
        if not times:
            return {"rounds_per_sec": 0.0, "mean_round_s": 0.0,
                    "median_round_s": 0.0, "samples_per_sec": 0.0}
        med = float(np.median(times))
        sps = float(np.median([s / max(t, 1e-9) for s, t in zip(samples, times)]))
        out = {
            "rounds_per_sec": 1.0 / max(med, 1e-9),
            "mean_round_s": sum(times) / len(times),
            "median_round_s": med,
            "samples_per_sec": sps,
        }
        if not torch.is_floating_point(self.x_all):
            out["tokens_per_sec"] = sps * int(np.prod(self.x_all.shape[1:]))
        return out
