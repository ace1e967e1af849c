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

With an attack or a defense on (the trust path), the round stacks its
clients' final variables into one ``[slots, D]`` fp32 matrix on the card, in
the JAX package's ``ravel_pytree`` order, with their step counts, instead of
summing them; the security tail (``_security_round``, one plain function of
torch ops, the JAX package's ``_build_security_fn``) then runs the stacked
model attack on the malicious rows, the stacked defense and the algorithm's
server step.  Data-poisoning attacks stamp each malicious client's shard at
pack time.  An analysis attack (``dlg``, ``invert_gradient``,
``revealing_labels_from_gradients``) stacks the rows too, but the round
aggregates as a clean one does: every ``dlg_frequency`` rounds the attacker
analyses one intercepted row (``_analyze``) against the round's
pre-aggregation global, and training is left as it was, bit for bit.
Local DP noises each client's variables after its last step (a generator
per client); central DP noises the global variables after the server
step.  Every draw comes from a seeded ``torch.Generator``
(``utils/rng.py``), not from ``jax.random``.

With ``xla_client_chunk: k`` the padded round trains its slots k at a time
(``ml.engine.train.build_chunked_local_train``: ``torch.func.vmap`` over k
parameter sets, the JAX round's ``jax.vmap(one_client)``; the flash kernels
then launch once a chunk at ``k*B``); the packed round does not read the
knob, as in the JAX package.

The cohort of each round is the population manager's draw (``uniform``,
``stratified`` or ``importance``, ``selection_policy``), the same clients as
the JAX package picks for the same registry state, or with
``population_stacked`` the row of the whole run's one stacked draw; after
each round the manager records it (``observe_round``, with the round's wall
seconds, which the stratified policy reads).  With ``fl_mode: async`` each
round is one buffer flush instead: a virtual arrival queue, seeded from
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
from ...core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
from ...core.population import PopulationManager, stacked_cohorts
from ...core.schedule import RuntimeEstimator, SeqTrainScheduler
from ...core.security.fedml_attacker import FedMLAttacker
from ...core.security.fedml_defender import FedMLDefender
from ...core.security.stacked import (_wmean, build_stacked_attack, build_stacked_defense,
                                      init_defense_state)
from ...device import fp32_matmul
from ...ml.aggregator.aggregator_creator import create_server_aggregator
from ...ml.engine.packed import PackedSchedule, build_packed_device_fn, pack_round, s_max_for
from ...ml.engine.train import build_chunked_local_train, build_local_train, init_variables
from ...ml.trainer.trainer_creator import _TAG_DATASETS, loss_kind_for_dataset
from ...models.convert import FlatLayout
from ...models.hub import data_storage_dtype
from ...utils.metrics import MetricsLogger
from ...utils.rng import seeded_generator
from .algorithms import create_inmesh_algorithm, out_buffer, split_slots, store_out, tree_add_

logger = logging.getLogger(__name__)


def _is_set(args, key: str) -> bool:
    v = getattr(args, key, None)
    if isinstance(v, str):
        return v.strip().lower() not in ("", "0", "false", "off", "no", "none")
    return bool(v)


def _compiled(a, k) -> bool:
    return str(getattr(a, k, "host") or "host").lower() == "compiled"


# (knob, is it switched on?, the ROADMAP.md item that ports it)
_UNPORTED_KNOBS = (
    ("server_state", lambda a, k: str(getattr(a, k, "replicated") or "replicated").lower()
     != "replicated", "queue A, item 10: server planes"),
    ("agg_plane", lambda a, k: str(getattr(a, k, "host") or "host").lower() != "host",
     "queue A, item 10: server planes"),
    ("defense_plane", _compiled, "queue A, item 10: server planes (parallel/sec_plane.py)"),
    ("dp_plane", _compiled, "queue A, item 10: server planes (parallel/sec_plane.py)"),
    ("secagg_plane", _compiled, "queue A, item 10: server planes (parallel/sec_plane.py)"),
    ("checkpoint_dir", _is_set, "queue A, item 9b: state (checkpointing)"),
    ("obs_trace", _is_set, "queue A, item 9d: the rest of the message plane (obs)"),
    ("obs_telemetry", _is_set, "queue A, item 9d: the rest of the message plane (obs)"),
    ("obs_health", _is_set, "queue A, item 9d: the rest of the message plane (obs)"),
    ("enable_profiler", _is_set, "queue A, item 9d: the rest of the message plane (obs)"),
)


def refuse_unported_knobs(args) -> None:
    for key, on, item in _UNPORTED_KNOBS:
        if on(args, key):
            raise NotImplementedError(
                f"{key}={getattr(args, key)!r} is not ported to the torch simulator yet "
                f"(ROADMAP.md {item})")


# the salt of the security tail's generators, the JAX package's
# fold_in(sub, 999331)
SECURITY_SALT = 999331


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
        attacker = FedMLAttacker.get_instance()
        defender = FedMLDefender.get_instance()
        self.analysis_attacked = attacker.is_analysis_attack()
        if (attacker.is_attack_enabled() and not attacker.is_model_attack()
                and not self.analysis_attacked and not attacker.is_data_poisoning_attack()):
            # fail loud rather than report clean-FedAvg metrics as an attack
            # experiment's result
            raise NotImplementedError(
                f"attack_type {attacker.attack_type!r} has no XLA-backend hook")
        self.defended = defender.is_defense_enabled()
        self.model_attacked = attacker.is_model_attack()
        # the security tail aggregates under a defense or a model attack; an
        # analysis attack only reads one row of the stack
        self.secured = self.defended or self.model_attacked
        self.needs_stack = self.secured or self.analysis_attacked
        self.analysis_victims: List[int] = []  # the client analysed, each analysed round
        self.module = model
        self.device = torch.device(device)

        self.num_clients = int(args.client_num_in_total)
        self.clients_per_round = int(args.client_num_per_round)
        self.batch_size = int(getattr(args, "batch_size", 32))
        self.epochs = int(getattr(args, "epochs", 1))
        self.seed = int(getattr(args, "random_seed", 0))
        # every ported loss runs in the round; tag prediction's class ids
        # become one-hot at pack time (_pack_data), so it rides the bce loss
        ds = str(getattr(args, "dataset", "")).lower()
        self._multihot_labels = ds in _TAG_DATASETS
        self.loss_kind = "bce" if self._multihot_labels else loss_kind_for_dataset(ds)

        self._pack_data()
        self.variables = init_variables(model, self.device, seed=self.seed)
        self.algo = create_inmesh_algorithm(args)
        self.server_state = self.algo.init_server_state(self.variables)
        self.client_state = self.algo.init_client_state(self.num_clients, self.variables)
        self.packed = bool(getattr(args, "xla_pack", False))
        post_train = self._ldp_hook()
        if self.packed:
            # one card: one stream whose slots are the whole cohort
            self.slots = self.clients_per_round
            self.s_max = s_max_for(self.max_client_n, self.slots, self.batch_size, self.epochs)
            self._device_fn = build_packed_device_fn(
                self.module, self.args, self.algo, loss=self.loss_kind,
                pregather=bool(getattr(args, "xla_pregather", False)),
                stream=str(getattr(args, "xla_stream", "while")),
                post_train=post_train, capture_updates=self.needs_stack)
        else:
            self._local_train = build_local_train(
                self.module, self.args, self.batch_size, self.padded_n, loss=self.loss_kind,
                grad_hook=self.algo.grad_hook(), post_train=post_train)
            self._chunk_train = None
            self._chunk_warned: set = set()
            if int(getattr(args, "xla_client_chunk", 0) or 0) > 1:
                self._chunk_train = build_chunked_local_train(
                    self.module, self.args, self.batch_size, self.padded_n,
                    loss=self.loss_kind, grad_hook=self.algo.grad_hook(), post_train=post_train)
        if self.secured:
            self._build_security()
        self.runtime_estimator = RuntimeEstimator(1, uniform_devices=True)
        self.scheduler = SeqTrainScheduler(1, estimator=self.runtime_estimator)
        self._seen_buckets: set = set()
        self.population = PopulationManager.from_args(
            self.args, np.arange(self.num_clients), num_samples=self.client_counts,
            rng_style="mt19937")
        # population_stacked: the whole run's cohorts in one vectorized draw,
        # a different schedule from the per-round seeded one
        self._stacked_schedule = None
        if bool(getattr(args, "population_stacked", False)):
            self._stacked_schedule = stacked_cohorts(
                self.num_clients, self.clients_per_round, int(getattr(args, "comm_round", 1)),
                seed=self.seed)
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
        ``data_storage_dtype``; integer inputs (token ids) keep their dtype.
        Tag prediction's class ids are stored one-hot."""
        b = self.batch_size
        counts = np.array([self.local_num_dict[i] for i in range(self.num_clients)], np.int64)
        self.max_client_n = int(counts.max())
        self.padded_n = max(b, -(-self.max_client_n // b) * b)
        xs, ys = [], []
        idx = np.zeros((self.num_clients, self.padded_n), np.int64)
        cursor = 0
        attacker = FedMLAttacker.get_instance()
        poisoning = attacker.is_data_poisoning_attack()
        bad = set(attacker.get_byzantine_idxs(self.num_clients)) if poisoning else set()
        self.poisoned_clients: List[int] = []
        for i in range(self.num_clients):
            xi, yi = self.local_train_dict[i]
            if i in bad:
                # the data side of the attack stamps here, where each
                # malicious client's shard is assembled
                xi, yi = attacker.poison_local_data(i, self.num_clients, xi, yi)
                self.poisoned_clients.append(i)
            if self._multihot_labels and np.asarray(yi).ndim == 1:
                # tag prediction with class ids: one-hot for the bce loss
                # (mounted multi-label sets arrive multi-hot)
                yi = np.eye(self.class_num, dtype=np.float32)[np.asarray(yi)]
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
        if self._stacked_schedule is not None:
            return self._stacked_schedule[round_idx % len(self._stacked_schedule)]
        return np.asarray(self.population.select(round_idx, self.clients_per_round), np.int64)

    def _resolve_chunk(self, slots: int) -> int:
        """Clients trained together (``xla_client_chunk``): the largest
        divisor of the round's slot count at most the request, with the JAX
        package's warning when it differs from the request; 1 when unset."""
        req = int(getattr(self.args, "xla_client_chunk", 0) or 0)
        if req <= 1:
            return 1
        k = max(d for d in range(1, min(req, slots) + 1) if slots % d == 0)
        if k != req and (req, slots) not in self._chunk_warned:
            self._chunk_warned.add((req, slots))
            logger.warning("xla_client_chunk=%d does not divide clients/device=%d; using %d",
                           req, slots, k)
        return k

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
    # the trust path: local DP, the security tail
    # ------------------------------------------------------------------
    def _ldp_hook(self):
        """The per-client noise fn ``(variables, gen) -> variables`` when
        local DP is on, else None."""
        dp = FedMLDifferentialPrivacy.get_instance()
        if not dp.is_local_dp_enabled():
            return None
        mechanism = dp.mechanism
        return lambda tree, gen: mechanism.add_noise(tree, gen)

    def _build_security(self):
        """The security tail's attack and defense (``_security_round`` runs
        them); the soteria probe's mask is taken once, here."""
        attacker = FedMLAttacker.get_instance()
        defender = FedMLDefender.get_instance()
        self._attack = (build_stacked_attack(self.args, attacker.attack_type)
                        if self.model_attacked else None)
        self._defense = None
        if self.defended:
            probe_mask = defender.soteria_probe_mask()
            if probe_mask is not None:
                probe_mask = probe_mask.to(self.device)
            self._defense = build_stacked_defense(self.args, defender.defense_type,
                                                  probe_mask=probe_mask)
        self._defense_state = None
        self._defense_n = -1
        self._byzantine = set(attacker.get_byzantine_idxs(self.num_clients)) \
            if self.model_attacked else set()
        self.malicious_per_round: List[List[int]] = []
        self.security_ms: List[float] = []
        self._tail_events = None

    def _ensure_defense_state(self, n_real: int, dim: int):
        if not self.defended:
            return {}
        if self._defense_state is None or self._defense_n != n_real:
            # cross-round per-slot state (foolsgold's history, wbc's previous
            # rows) is positional; a changed participant count resets it
            self._defense_state = init_defense_state(self._defense.t, n_real, dim, self.device)
            self._defense_n = n_real
        return self._defense_state

    def _security_round(self, round_idx: int, mat_all: torch.Tensor, taus: np.ndarray,
                        ids: np.ndarray, counts: np.ndarray, cex, ext) -> None:
        """The round's aggregation from its stacked rows: the model attack on
        the malicious rows, the defense, then the algorithm's server step
        (the ``ServerAggregator`` hook order).  The fp32 products run in full
        fp32 (TF32 off on the card).  The attack draws from (seed, 999331,
        round, 0), the defense from (seed, 999331, round, 1)."""
        real_sel = np.where(counts > 0)[0]
        if real_sel.size == 0:
            return
        if self.device.type == "cuda":
            if torch.backends.cuda.matmul.allow_tf32:
                raise RuntimeError("the security tail needs fp32 products: TF32 is on")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        algo, dev = self.algo, self.device
        layout = FlatLayout.of(self.variables)
        g_vec = layout.ravel(self.variables)

        def unravel(vec):
            return layout.unravel(vec, self.variables)

        sub = mat_all.index_select(0, torch.as_tensor(real_sel, device=dev))
        w = torch.as_tensor(counts[real_sel], dtype=torch.float32, device=dev)
        bad = [int(ids[i]) for i in real_sel if int(ids[i]) in self._byzantine]
        self.malicious_per_round.append(sorted(bad))
        mal = torch.as_tensor([float(int(ids[i]) in self._byzantine) for i in real_sel],
                              dtype=torch.float32, device=dev)
        gen_a = seeded_generator((self.seed, SECURITY_SALT, round_idx, 0), dev)
        gen_d = seeded_generator((self.seed, SECURITY_SALT, round_idx, 1), dev)
        dstate = self._ensure_defense_state(int(real_sel.size), layout.dim)
        with torch.no_grad():
            if self._attack is not None:
                sub = self._attack(sub, w, g_vec, mal, gen_a)
            if algo.aggregates_via_acc:
                if self._defense is not None:
                    agg, dstate = self._defense.aggregate(sub, w, g_vec, gen_d, dstate,
                                                          layout=layout)
                else:
                    agg = _wmean(sub, w)
                # the robust aggregate as a weighted sum: every acc strategy
                # divides by wsum
                wsum = float(counts[real_sel].sum())
                acc = unravel(agg * wsum)
                new_vars, new_state = algo.server_update(acc, wsum, ext, self.variables,
                                                         self.server_state)
            else:
                # the ext strategies rebuild ext from the defended rows
                w2 = w
                if self._defense is not None:
                    sub, w2, dstate = self._defense.rows_fn(sub, w, g_vec, gen_d, dstate,
                                                            rows_mode=True, layout=layout)
                meta = algo.security_meta(taus, cex, real_sel)
                ext2 = algo.ext_from_rows(sub, w2, w, meta, g_vec, unravel)
                acc = unravel(torch.matmul(w2, sub))
                new_vars, new_state = algo.server_update(acc, float(torch.sum(w2)), ext2,
                                                         self.variables, self.server_state)
        self.variables, self.server_state = new_vars, new_state
        self._defense_state = dstate
        if self.device.type == "cuda":
            end.record()
            self._tail_events = (start, end)
        else:
            self.security_ms.append((time.perf_counter() - t0) * 1e3)

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------
    def _run_round(self, round_idx: int, ids: np.ndarray, counts: np.ndarray, cex=None):
        """Train the scheduled clients, in order (k at a time under
        ``xla_client_chunk``), from the current global variables, apply the
        server step (or the security tail) and fold the clients' outputs into
        the client state.  ``cex`` is the round's client extras
        (``algo.gather_client_extras``).  Returns the mean loss tensor."""
        algo = self.algo
        acc = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in self.variables.items()}
        if self.needs_stack:
            layout = FlatLayout.of(self.variables)
            update = torch.zeros((len(ids), layout.dim), dtype=torch.float32, device=self.device)
            update_rows = layout.views(update)
            taus = np.zeros((len(ids),), np.float32)
        ext = algo.zero_contrib(self.variables)
        outs = out_buffer(algo, self.variables, len(ids))
        cex_rows, out_rows = split_slots(cex, len(ids)), split_slots(outs, len(ids))
        wsum = 0.0
        lsum = torch.zeros((), dtype=torch.float32, device=self.device)
        k = self._resolve_chunk(len(ids))
        for first in range(0, len(ids), k):
            chunk = range(first, first + k)
            if all(counts[s] <= 0 for s in chunk):
                continue  # contributes nothing, as weight-0 slots in the mesh round
            for s, result in zip(chunk, self._train_slots(round_idx, chunk, ids, counts,
                                                          cex_rows)):
                n_i = int(counts[s])
                if n_i <= 0:
                    continue
                w = float(n_i)
                with torch.no_grad():
                    if self.needs_stack:
                        for name, p in result.variables.items():
                            update_rows[name][s].copy_(p)
                        taus[s] = result.steps
                    for name, p in result.variables.items():
                        acc[name].add_(p.float(), alpha=w)
                    contrib, out = algo.client_result(self.variables, result, w, 1.0,
                                                      cex_rows[s], self.server_state)
                    ext = tree_add_(ext, contrib)
                    store_out(out_rows[s], out)
                wsum += w
                lsum += result.loss * w
        mean_loss = lsum / max(wsum, 1e-9)
        if self.needs_stack:
            outs = {"algo": outs, "update": update, "tau": taus}
        self._server_step(round_idx, acc, wsum, ext, ids, counts, cex, outs)
        return mean_loss

    def _train_slots(self, round_idx: int, chunk: range, ids: np.ndarray, counts: np.ndarray,
                     cex_rows: list) -> list:
        """The local training of one chunk of schedule slots: one client
        through the engine, or k through its chunked form (clients with no
        sample ride along masked, as weight-0 slots do in the mesh round)."""
        with torch.no_grad():
            extras = [self.algo.engine_extra(cex_rows[s], self.server_state) for s in chunk]
        seeds = [(self.seed, round_idx, int(ids[s])) for s in chunk]
        if len(chunk) == 1:
            rows = self.client_idx[int(ids[chunk[0]])]
            return [self._local_train(self.variables, self.x_all.index_select(0, rows),
                                      self.y_all.index_select(0, rows), int(counts[chunk[0]]),
                                      seed=seeds[0], extra=extras[0])]
        rows = self.client_idx.index_select(
            0, torch.as_tensor(ids[chunk.start:chunk.stop], device=self.device)).reshape(-1)
        shape = (len(chunk), self.padded_n)
        x = self.x_all.index_select(0, rows).reshape(shape + tuple(self.x_all.shape[1:]))
        y = self.y_all.index_select(0, rows).reshape(shape + tuple(self.y_all.shape[1:]))
        return self._chunk_train(self.variables, x, y, [int(counts[s]) for s in chunk], seeds,
                                 extras)

    def _run_packed_round(self, round_idx: int, ids: np.ndarray, counts: np.ndarray, cex=None):
        """The packed stream of the scheduled clients, then the server step
        and the clients' outputs into the client state.  Returns the mean
        per-sample loss tensor."""
        acc, wsum, lsum, cnt, ext, outs = self._device_fn(
            self.variables, self.server_state, self.x_all, self.y_all,
            self._packed_inputs(ids, counts, round_idx), cex, len(ids),
            seed_round=(self.seed, round_idx), ids=ids)
        self._server_step(round_idx, acc, wsum, ext, ids, counts, cex, outs)
        return lsum / max(cnt, 1.0)

    def _server_step(self, round_idx: int, acc, wsum: float, ext, ids: np.ndarray,
                     counts: np.ndarray, cex, outs) -> None:
        """The algorithm's server step, or with a model attack or a defense on
        the security tail on the round's stacked rows; then the analysis
        attack, if one is on, and the clients' outputs into the client
        state."""
        prev_global = self.variables
        if self.secured:
            self._security_round(round_idx, outs["update"], outs["tau"], ids, counts, cex, ext)
        else:
            with torch.no_grad():
                self.variables, self.server_state = self.algo.server_update(
                    acc, wsum, ext, self.variables, self.server_state)
        if self.needs_stack:
            if self.analysis_attacked:
                self._analyze(round_idx, prev_global, outs["update"], ids, counts)
            outs = outs["algo"]
        with torch.no_grad():
            self.client_state = self.algo.apply_client_outs(self.client_state, ids, outs)

    def _analyze(self, round_idx: int, prev_global, update: torch.Tensor, ids: np.ndarray,
                 counts: np.ndarray) -> None:
        """The analysis attack on one intercepted update, every
        ``dlg_frequency`` rounds: the victim is the first real client of the
        round's layout in the byzantine set, else the first real client; its
        row of the update stack is analysed against the round's
        pre-aggregation global, at input shape ``(dlg_batch_size,) +`` a
        sample's."""
        if round_idx % max(1, int(getattr(self.args, "dlg_frequency", 1))) != 0:
            return
        real_sel = np.where(counts > 0)[0]
        if real_sel.size == 0:
            return
        attacker = FedMLAttacker.get_instance()
        bad = set(attacker.get_byzantine_idxs(self.num_clients))
        victim = ([int(i) for i in real_sel if int(ids[i]) in bad] or [int(real_sel[0])])[0]
        self.analysis_victims.append(int(ids[victim]))
        row = FlatLayout.of(prev_global).unravel(update[victim], prev_global)
        attacker.analyze_update(
            self.module, prev_global, row,
            (int(getattr(self.args, "dlg_batch_size", 1)),) + tuple(self.x_all.shape[1:]),
            self.class_num)

    def train(self) -> Dict[str, Any]:
        """The run's rounds, with fp32 products in full fp32 (TF32 off) and
        the flags set back when the run ends."""
        with fp32_matmul():
            return self._train()

    def _train(self) -> Dict[str, Any]:
        comm_round = int(self.args.comm_round)
        freq = int(getattr(self.args, "frequency_of_the_test", 10))
        dp = FedMLDifferentialPrivacy.get_instance()
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
            if dp.is_local_dp_enabled():
                # account before the round releases anything: an exhausted
                # budget aborts the round, it does not trail it
                dp.spend_budget(int(participated.sum()))
            run = self._run_packed_round if self.packed else self._run_round
            mean_loss = run(round_idx, ids, counts, cex)
            self.algo.host_round_end(ids, participated, round_idx)
            if self.async_mode:
                self._async_round_end()
            if dp.is_global_dp_enabled():
                self.variables = dp.add_global_noise(self.variables)
            self._sync()
            if self.secured and self._tail_events is not None:
                self.security_ms.append(self._tail_events[0].elapsed_time(self._tail_events[1]))
                self._tail_events = None
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
            # population accounting: everyone sampled was invited and reported
            self.population.observe_round(round_idx, sampled, seconds=dt)
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
        # task-specific extras (F1, exact match) pass through
        for k, v in stats.items():
            if k.startswith("test_") and k not in ("test_correct", "test_total", "test_loss"):
                out[k] = round(float(v), 4)
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
