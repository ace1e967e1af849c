"""The port's round simulator: the padded and the packed rounds of
``fedml_tpu/simulation/xla/fed_sim.py`` (``XLASimulator``) on one CUDA card.

The JAX simulator compiles a round into one XLA program over a device mesh:
the sampled clients are sharded over a ``client`` axis, each device trains
its clients through the compiled engine, and a ``psum`` reduces the weighted
sums.  On one card the ``client`` axis and its ``psum`` become a loop over
the round's clients, in the order ``_schedule`` gives them (the LPT scheduler
of ``core/schedule`` at one slot: heaviest first, as the JAX package lays
them out):

* the whole dataset is uploaded once (``_pack_data``) with a per-client
  index table padded to ``padded_n`` rows, so a client's data is one
  on-device gather; float data are stored in ``data_storage_dtype`` (bf16
  when a ResNet computes in bf16);
* the padded round (default) trains each client from the round's global
  variables (``ml.engine.train.build_local_train``, with the algorithm's
  grad hook) and adds ``n_i * variables`` into an fp32 accumulator, the
  algorithm's contribution into ``ext`` and its output into the client's
  slot;
* the packed round (``xla_pack``) streams the clients' batches back to back
  (``ml.engine.packed``), flushing the same three at each client's last
  step;
* the algorithm's server step turns the accumulator and ``ext`` into the
  next global variables, and the slots' outputs are scatter-added into the
  algorithm's client-state table (SCAFFOLD's c_i, FedDyn's h_i).

The cohort of each round is the population manager's ``mt19937`` draw, the
same clients as the JAX package picks.  With ``fl_mode: async`` each round is
one buffer flush instead: a virtual arrival queue, seeded from
``random_seed``, decides the flush's clients and their staleness, over the
cohort drawn once at construction, as in the JAX package.  Knobs of
subsystems the port does not have yet raise ``NotImplementedError`` when set;
none is ignored.

The class keeps the JAX name so a reader finds its counterpart.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ...core.async_fl import VirtualArrivalQueue
from ...core.population import PopulationManager
from ...core.schedule import RuntimeEstimator, SeqTrainScheduler
from ...ml.aggregator.aggregator_creator import create_server_aggregator
from ...ml.engine.packed import PackedSchedule, build_packed_device_fn, pack_round, s_max_for
from ...ml.engine.train import build_local_train, init_variables
from ...ml.trainer.trainer_creator import _TAG_DATASETS, loss_kind_for_dataset
from ...models.hub import data_storage_dtype
from ...utils.metrics import MetricsLogger
from .algorithms import create_inmesh_algorithm, out_buffer, split_slots, store_out, tree_add_

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
    ("xla_client_chunk", _is_set, "queue A, item 6d: xla_client_chunk"),
    ("population_stacked", _is_set, "queue A, item 6c: population_stacked"),
    ("server_state", lambda a, k: str(getattr(a, k, "replicated") or "replicated").lower()
     != "replicated", "queue A, item 15: server planes"),
    ("agg_plane", lambda a, k: str(getattr(a, k, "host") or "host").lower() != "host",
     "queue A, item 15: server planes"),
    ("checkpoint_dir", _is_set, "queue A, item 16: checkpointing"),
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
        self.seed = int(getattr(args, "random_seed", 0))
        ds = str(getattr(args, "dataset", "")).lower()
        if ds in _TAG_DATASETS:
            raise NotImplementedError(
                f"dataset {ds!r} (multi-hot labels) is not ported yet (ROADMAP.md queue A, item 14)")
        self.loss_kind = loss_kind_for_dataset(ds)

        self._pack_data()
        self.variables = init_variables(model, self.device, seed=self.seed)
        self.algo = create_inmesh_algorithm(args)
        self.server_state = self.algo.init_server_state(self.variables)
        self.client_state = self.algo.init_client_state(self.num_clients, self.variables)
        self.packed = bool(getattr(args, "xla_pack", False))
        if self.packed:
            # one card: one stream whose slots are the whole cohort
            self.slots = self.clients_per_round
            self.s_max = s_max_for(self.max_client_n, self.slots, self.batch_size, self.epochs)
            self._device_fn = build_packed_device_fn(
                self.module, self.args, self.algo, loss=self.loss_kind,
                pregather=bool(getattr(args, "xla_pregather", False)),
                stream=str(getattr(args, "xla_stream", "while")))
        else:
            self._local_train = build_local_train(
                self.module, self.args, self.batch_size, self.padded_n, loss=self.loss_kind,
                grad_hook=self.algo.grad_hook())
        self.runtime_estimator = RuntimeEstimator(1, uniform_devices=True)
        self.scheduler = SeqTrainScheduler(1, estimator=self.runtime_estimator)
        self._seen_buckets: set = set()
        self.population = PopulationManager.from_args(
            self.args, np.arange(self.num_clients), rng_style="mt19937")
        self.async_mode = str(getattr(args, "fl_mode", "sync") or "sync").lower() == "async"
        if self.async_mode:
            self._async_init()
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
        masked out by its count).  Float inputs are stored in
        ``data_storage_dtype``; integer inputs (token ids) keep their dtype."""
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
        self._client_rows = idx  # host copy: the packed round's schedule reads it
        self.client_idx = torch.from_numpy(idx).to(self.device)
        x_all = torch.from_numpy(np.concatenate(xs, 0))
        if x_all.is_floating_point():
            x_all = x_all.to(data_storage_dtype(self.args, self.module))
        self.x_all = x_all.to(self.device)
        self.y_all = torch.from_numpy(np.concatenate(ys, 0)).to(self.device)
        logger.info("packed %d clients (max_n=%d padded_n=%d) data %s (%s) onto %s",
                    self.num_clients, self.max_client_n, self.padded_n,
                    tuple(self.x_all.shape), self.x_all.dtype, self.device)

    def _client_sampling(self, round_idx: int) -> np.ndarray:
        return np.asarray(self.population.select(round_idx, self.clients_per_round), np.int64)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _client_steps(self, n: int) -> int:
        """A client's cost in the packed round's unit: its steps, ceil(n/B)
        per epoch."""
        if n <= 0:
            return 0
        return -(-int(n) // self.batch_size) * self.epochs

    def _schedule(self, sampled: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Lay the cohort out through the scheduler (one slot: the order in
        which the round trains its clients).  Costs are what each round runs:
        steps for the packed round, samples for the padded one.  Returns
        (client ids, is real)."""
        if self.packed:
            sizes = [self._client_steps(self.local_num_dict[int(c)]) for c in sampled]
        else:
            sizes = [self.local_num_dict[int(c)] for c in sampled]
        ids2d, mask2d, _ = self.scheduler.schedule(sampled, sizes)
        return ids2d.reshape(-1), mask2d.reshape(-1)

    def _packed_inputs(self, ids: np.ndarray, counts: np.ndarray,
                       round_idx: int) -> PackedSchedule:
        """The round's packed stream (one device), trimmed to a bucket of its
        real steps: quantum s_max/8, so at most 8 buffer shapes a run."""
        sched = pack_round(ids.reshape(1, -1), counts.reshape(1, -1),
                           lambda cid: self._client_rows[cid], self.batch_size,
                           self.epochs, self.seed, round_idx, self.s_max)
        s_used = max(int(sched.n_steps.max()), 1)
        quantum = max(1, -(-self.s_max // 8))
        s_bucket = min(-(-s_used // quantum) * quantum, self.s_max)
        # the first round at a new bucket shape stays out of the runtime
        # model's fit, as in the JAX package (where that round compiles)
        self._bucket_compiling = s_bucket not in self._seen_buckets
        self._seen_buckets.add(s_bucket)
        self._s_bucket = s_bucket
        return PackedSchedule(sched.idx[0, :s_bucket], sched.mask[0, :s_bucket],
                              sched.boundary[0, :s_bucket], sched.weight[0, :s_bucket],
                              sched.slot[0, :s_bucket], sched.n_steps[0])

    # ------------------------------------------------------------------
    # buffered-async virtual arrival queue (fl_mode=async)
    # ------------------------------------------------------------------
    def _async_init(self):
        """Deterministic virtual-time schedule: per-client durations drawn
        once from ``random_seed``, a fixed cohort (the round-0 population
        draw: async cycles re-dispatch the same pool, and the population is
        never drawn again), and a flush size of ``async_buffer_size``
        arrivals.  Each round is one flush."""
        cap = int(getattr(self.args, "async_buffer_size", 0) or 0) or self.clients_per_round
        if cap > self.clients_per_round:
            logger.warning("async_buffer_size=%d exceeds the cohort (%d): clamping",
                           cap, self.clients_per_round)
            cap = self.clients_per_round
        self._async_cap = cap
        self._async_max_staleness = int(getattr(self.args, "async_max_staleness", 0) or 0)
        rng = np.random.RandomState(self.seed)
        self._async_durations = 0.5 + rng.exponential(1.0, size=self.num_clients)
        self._async_cohort = [int(c) for c in self._client_sampling(0)]
        self._async_version = 0
        self._async_dispatched = {c: 0 for c in self._async_cohort}
        self._async_queue = VirtualArrivalQueue()
        for c in self._async_cohort:
            self._async_queue.push(c, float(self._async_durations[c]))
        self._async_t = 0.0
        self._async_dropped_stale = 0
        self.async_flushes: List[Dict[int, int]] = []  # each flush's staleness by client

    def _async_next_flush(self) -> Tuple[np.ndarray, Dict[int, int]]:
        """Pop arrivals off the virtual queue until one buffer's worth
        accrues; returns (cohort sorted by id, staleness by id)."""
        picked: List[int] = []
        stal: Dict[int, int] = {}
        v = self._async_version
        while len(picked) < self._async_cap:
            t, cid = self._async_queue.pop()
            self._async_t = t
            s = v - self._async_dispatched[cid]
            if s > self._async_max_staleness:
                # too stale to aggregate: fresh work beats idling
                self._async_dropped_stale += 1
                self._async_dispatched[cid] = v
                self._async_queue.push(cid, t + float(self._async_durations[cid]))
                continue
            picked.append(cid)
            stal[cid] = int(s)
            if self._async_max_staleness >= 1 and len(picked) < self._async_cap:
                # FedBuff: the client keeps training while its delta waits
                self._async_dispatched[cid] = v
                self._async_queue.push(cid, t + float(self._async_durations[cid]))
        return np.asarray(sorted(picked), np.int64), stal

    def _async_round_end(self):
        """The flush applied: bump the version and re-dispatch every idle
        cohort member on the fresh global at the flush's virtual time."""
        self._async_version += 1
        in_flight = set(self._async_queue.clients())
        for c in self._async_cohort:
            if c not in in_flight:
                self._async_dispatched[c] = self._async_version
                self._async_queue.push(c, self._async_t + float(self._async_durations[c]))

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------
    def _run_round(self, round_idx: int, ids: np.ndarray, counts: np.ndarray, cex=None):
        """Train the scheduled clients, in order, from the current global
        variables, apply the server step and fold the clients' outputs into
        the client state.  ``cex`` is the round's client extras
        (``algo.gather_client_extras``).  Returns the mean loss tensor."""
        algo = self.algo
        acc = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in self.variables.items()}
        ext = algo.zero_contrib(self.variables)
        outs = out_buffer(algo, self.variables, len(ids))
        cex_rows, out_rows = split_slots(cex, len(ids)), split_slots(outs, len(ids))
        wsum = 0.0
        lsum = torch.zeros((), dtype=torch.float32, device=self.device)
        for s, (cid, n_i) in enumerate(zip(ids.tolist(), counts.tolist())):
            if n_i <= 0:
                continue  # contributes nothing, as a weight-0 slot in the mesh round
            cex_i = cex_rows[s]
            rows = self.client_idx[cid]
            with torch.no_grad():
                extra = algo.engine_extra(cex_i, self.server_state)
            result = self._local_train(self.variables, self.x_all.index_select(0, rows),
                                       self.y_all.index_select(0, rows), n_i,
                                       seed=(self.seed, round_idx, cid), extra=extra)
            w = float(n_i)
            with torch.no_grad():
                for k, p in result.variables.items():
                    acc[k].add_(p.float(), alpha=w)
                contrib, out = algo.client_result(self.variables, result, w, 1.0, cex_i,
                                                  self.server_state)
                ext = tree_add_(ext, contrib)
                store_out(out_rows[s], out)
            wsum += w
            lsum += result.loss * w
        mean_loss = lsum / max(wsum, 1e-9)
        self._server_step(acc, wsum, ext, ids, outs)
        return mean_loss

    def _run_packed_round(self, round_idx: int, ids: np.ndarray, counts: np.ndarray, cex=None):
        """The packed stream of the scheduled clients, then the server step
        and the clients' outputs into the client state.  Returns the mean
        per-sample loss tensor."""
        acc, wsum, lsum, cnt, ext, outs = self._device_fn(
            self.variables, self.server_state, self.x_all, self.y_all,
            self._packed_inputs(ids, counts, round_idx), cex, len(ids))
        self._server_step(acc, wsum, ext, ids, outs)
        return lsum / max(cnt, 1.0)

    def _server_step(self, acc, wsum: float, ext, ids: np.ndarray, outs) -> None:
        with torch.no_grad():
            self.variables, self.server_state = self.algo.server_update(
                acc, wsum, ext, self.variables, self.server_state)
            self.client_state = self.algo.apply_client_outs(self.client_state, ids, outs)

    def train(self) -> Dict[str, Any]:
        comm_round = int(self.args.comm_round)
        freq = int(getattr(self.args, "frequency_of_the_test", 10))
        last: Dict[str, Any] = {}
        for round_idx in range(comm_round):
            t0 = time.time()
            if self.async_mode:
                sampled, stal_map = self._async_next_flush()
                self.algo.set_staleness(stal_map)
                self.async_flushes.append(stal_map)
            else:
                sampled = self._client_sampling(round_idx)
            ids, real = self._schedule(sampled)
            counts = np.where(real > 0, self.client_counts[ids], 0)
            # a sampled client with no samples contributes nothing
            participated = (counts > 0).astype(np.float32)
            cex = self.algo.gather_client_extras(self.client_state, ids, participated, round_idx)
            run = self._run_packed_round if self.packed else self._run_round
            mean_loss = run(round_idx, ids, counts, cex)
            self.algo.host_round_end(ids, participated, round_idx)
            if self.async_mode:
                self._async_round_end()
            self._sync()
            dt = time.time() - t0
            self.round_times.append(dt)
            if round_idx > 0:  # round 0 pays the first launches
                # the runtime model, in the unit _schedule passes as costs
                if not self.packed:
                    self.runtime_estimator.record(0, int(counts.sum()), dt)
                elif not self._bucket_compiling:
                    steps = -(-counts // self.batch_size) * self.epochs
                    self.runtime_estimator.record(0, int(steps.sum()), dt)
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
