"""FedBuff of the port's ``sp`` simulator (``fl_mode: async``; counterpart
of ``fedml_tpu/simulation/sp/async_fedavg/fedbuff_api.py``).

Buffered-async FedAvg: a virtual-arrival-time queue orders the clients'
reports (each client's simulated duration drawn once, ``0.5 +
RandomState(random_seed).exponential(1, n)``); the server parks each
accepted update in an ``UpdateBuffer`` and flushes it through
``server_update`` once ``async_buffer_size`` accrue.  Staleness is the
flushes a report missed (global version minus the version it trained
against) and discounts its weight by ``async_staleness_policy``; a report
staler than ``async_max_staleness`` is dropped and its client dispatched
again on the current global.  ``comm_round`` counts flushes.

Each client trains against the global it was dispatched (a by-version ring
of pinned globals), so a run is reproducible from ``random_seed`` alone.
Under full participation (``client_num_per_round == client_num_in_total``)
with ``async_buffer_size`` equal to the cohort, ``async_max_staleness: 0``
and the ``constant`` policy it is bit-identical to the sync ``FedAvgAPI``
loop: every flush collects the whole cohort at staleness 0 with weight
``n * 1.0``, drained in the sync loop's client order.  The cohort is the
round-0 population draw and stays fixed for the run.

With ``async_max_staleness`` >= 1 a client is dispatched again as soon as
it reports; if it reports again before the flush, the JAX twin's
``UpdateBuffer.add`` raises on the duplicate sender and the run dies.  The
port drops that second report instead (the message-plane server's rule,
one update a sender a cycle) and leaves the client idle until the flush
dispatches it again.  Where the JAX twin runs, the two agree.

``flush_log`` holds each flush's record (senders, staleness statistics,
reports dropped so far) and ``round_times`` each flush's seconds.  The JAX
twin's obs spans and counters are left out: they are no-ops unless the
``obs_*`` knobs are on, which the port refuses (ROADMAP.md queue A, item
9d: the rest of the message plane).  No client's data is poisoned on this
loop, so data poisoning is refused, as the JAX twin skips it; a model
attack picks its malicious updates by their position in the flush, as the
JAX twin's does.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List

import numpy as np

from ....core.async_fl import UpdateBuffer, VirtualArrivalQueue
from ..fedavg.fedavg_api import DATA_POISONING, FedAvgAPI

logger = logging.getLogger(__name__)


class FedBuffAPI(FedAvgAPI):
    SKIPPED_HOOKS = (DATA_POISONING,)

    def __init__(self, args, device, dataset, model):
        super().__init__(args, device, dataset, model)
        per_round = int(args.client_num_per_round)
        cap = int(getattr(args, "async_buffer_size", 0) or 0) or per_round
        if cap > per_round:
            logger.warning("async_buffer_size=%d exceeds the cohort (%d): clamping", cap,
                           per_round)
            cap = per_round
        self.buffer = UpdateBuffer(
            capacity=cap,
            policy=str(getattr(args, "async_staleness_policy", "constant") or "constant"),
            alpha=float(getattr(args, "async_staleness_alpha", 0.5) or 0.5),
            hinge_b=int(getattr(args, "async_hinge_b", 4) or 4),
        )
        self.max_staleness = int(getattr(args, "async_max_staleness", 0) or 0)
        rng = np.random.RandomState(int(getattr(args, "random_seed", 0)))
        # heterogeneous simulated round durations per client (the draw of
        # AsyncFedAvgAPI: reproducible from the seed alone)
        self.durations = 0.5 + rng.exponential(1.0, size=int(args.client_num_in_total))
        self.flush_log: List[Dict[str, Any]] = []

    def _train(self) -> Dict[str, Any]:
        total_flushes = int(self.args.comm_round)
        cohort = self._client_sampling(0)

        version = 0
        # pinned globals by version: a client trains against the exact model
        # it was dispatched, however stale it is by the time it reports
        params_ring: Dict[int, Any] = {0: self.w_global}
        dispatched_version: Dict[int, int] = {}
        queue = VirtualArrivalQueue()
        for cid in cohort:
            dispatched_version[cid] = 0
            queue.push(cid, float(self.durations[cid]))

        slot = self.client_list[0]
        flushes = 0
        dropped_stale = dropped_dup = 0
        last: Dict[str, Any] = {}
        t0 = time.time()
        while flushes < total_flushes:
            t, cid = queue.pop()
            if cid in self.buffer.senders():
                # a second report this cycle from a client whose update waits
                # in the buffer (it was dispatched again at once): one update
                # a sender a cycle, so it is dropped, as the message-plane
                # server drops it, and the client waits for the flush
                dropped_dup += 1
                continue
            v_dispatch = dispatched_version[cid]
            staleness = version - v_dispatch
            if staleness > self.max_staleness:
                # too stale to aggregate: fresh work beats idling
                dropped_stale += 1
                dispatched_version[cid] = version
                queue.push(cid, t + float(self.durations[cid]))
                continue
            # the version trained against is the sync loop's round_idx in
            # the equivalence configuration
            self.trainer.round_idx = v_dispatch
            slot.update_local_dataset(
                cid,
                self.train_data_local_dict[cid],
                self.test_data_local_dict[cid],
                self.train_data_local_num_dict[cid],
            )
            w = self._train_client(slot, params_ring[v_dispatch])
            self.buffer.add(cid, w, float(slot.local_sample_number), version=v_dispatch,
                            staleness=staleness)
            if self.max_staleness >= 1 and not self.buffer.ready():
                # FedBuff: the client keeps training while its delta waits
                dispatched_version[cid] = version
                queue.push(cid, t + float(self.durations[cid]))
            if not self.buffer.ready():
                continue

            entries = self.buffer.drain()
            stats = UpdateBuffer.staleness_stats(entries)
            self.w_global = self.server_update(self.buffer.weighted(entries))
            self.aggregator.set_model_params(self.w_global)
            self._sync()
            version += 1
            params_ring[version] = self.w_global
            for v in [v for v in params_ring if v < version - self.max_staleness]:
                del params_ring[v]
            record = {"flush": flushes, "version": version, "n_deltas": len(entries),
                      "dropped_stale": dropped_stale, "dropped_dup": dropped_dup, **stats}
            self.metrics.log(record)
            self.flush_log.append(dict(record, senders=[e.sender for e in entries],
                                       staleness=[e.staleness for e in entries]))
            self.round_times.append(time.time() - t0)
            # re-dispatch every idle contributor on the fresh global
            in_flight = set(queue.clients())
            for c in cohort:
                if c not in in_flight:
                    dispatched_version[c] = version
                    queue.push(c, t + float(self.durations[c]))
            if flushes % self.freq == 0 or flushes == total_flushes - 1:
                last = self._test_global(flushes)
            flushes += 1
            t0 = time.time()
        return last
