"""Argument / configuration system of the PyTorch port.

A copy of ``fedml_tpu/arguments.py`` adapted to stand alone: the same
``Arguments`` attribute bag (``from_dict``, ``load_yaml_config``,
``validate``) and the same YAML shape, so one config file drives both
packages::

    common_args:   { training_type, random_seed, ... }
    data_args:     { dataset, data_cache_dir, partition_method, partition_alpha, ... }
    model_args:    { model, ... }
    train_args:    { federated_optimizer, client_num_in_total, client_num_per_round,
                     comm_round, epochs, batch_size, client_optimizer, learning_rate, ... }
    validation_args: { frequency_of_the_test }
    device_args:   { using_gpu, device_type, ... }
    comm_args:     { backend, ... }
    tracking_args: { enable_wandb, log_file_dir, ... }

``backend: XLA`` (and ``MPI`` / ``NCCL``) selects the port's round simulator.
``validate`` keeps the JAX package's checks so a config that fails there fails
here too; the knob tables it checks against are copied below.  Knobs whose
subsystem the port does not have yet are refused where they would be used
(the simulator raises ``NotImplementedError``), never silently ignored.
``device_args.device_type: cpu`` asks for the CPU; every other value means the
CUDA card (``device.get_device``).
"""

from __future__ import annotations

import argparse
import os
from os import path
from typing import Any, Dict, List, Optional

import yaml

from .constants import (
    FEDML_SIMULATION_TYPE_SP,
    FEDML_TRAINING_PLATFORM_SIMULATION,
)

# knob tables copied from the JAX package (core/checkpoint, core/hierarchy/plan,
# core/async_fl, parallel/agg_plane, parallel/sec_plane)
JOURNAL_FSYNC_POLICIES = ("always", "never")
FAN_IN_TREE_LEVELS = (1, 2, 3)
FL_MODES = ("sync", "async")
ASYNC_STALENESS_POLICIES = ("constant", "polynomial", "hinge")
AGG_PLANES = ("host", "compiled")
AGG_WIRE_DTYPES = ("f32", "bf16")
SERVER_STATES = ("replicated", "sharded")
SEC_PLANES = ("host", "compiled")

_CONFIG_SECTIONS = (
    "common_args",
    "data_args",
    "model_args",
    "train_args",
    "validation_args",
    "device_args",
    "comm_args",
    "tracking_args",
    "attack_args",
    "defense_args",
    "dp_args",
    "parallel_args",
    # algorithm-family knob sections used by the example configs — an
    # unlisted section would be kept as a dict attr and its knobs silently
    # ignored (the value would quietly fall back to the in-code default)
    "ta_args",
    "vfl_args",
    "fault_args",
    "population_args",
    "obs_args",
    "async_args",
)


def add_args(parser: Optional[argparse.ArgumentParser] = None) -> argparse.Namespace:
    """CLI surface of the reference (``arguments.py:34-60``): five flags."""
    parser = parser or argparse.ArgumentParser(description="fedml_tpu_torch")
    parser.add_argument(
        "--yaml_config_file", "--cf", help="yaml configuration file", type=str, default=""
    )
    parser.add_argument("--run_id", type=str, default="0")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--node_rank", type=int, default=0)
    parser.add_argument("--role", type=str, default="client")
    args, _ = parser.parse_known_args()
    return args


class Arguments:
    """Flat attribute bag loaded from YAML sections (reference ``arguments.py:63-171``).

    Every key of every section becomes a top-level attribute; section names are
    conventional.  Unknown sections/keys are preserved verbatim.
    """

    def __init__(
        self,
        cmd_args: Optional[argparse.Namespace] = None,
        training_type: Optional[str] = None,
        comm_backend: Optional[str] = None,
    ):
        if cmd_args is not None:
            for k, v in cmd_args.__dict__.items():
                setattr(self, k, v)
        self.training_type = getattr(self, "training_type", None) or training_type
        self.backend = getattr(self, "backend", None) or comm_backend
        config_file = getattr(self, "yaml_config_file", "")
        if config_file:
            self.load_yaml_config(config_file)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "Arguments":
        """Build from a nested (sectioned) or already-flat dict."""
        args = cls()
        args.set_attr_from_config(config)
        return args

    def load_yaml_config(self, yaml_path: str) -> None:
        with open(yaml_path, "r") as f:
            config = yaml.safe_load(f)
        self.set_attr_from_config(config or {})
        self.yaml_paths = [yaml_path]

    def set_attr_from_config(self, configuration: Dict[str, Any]) -> None:
        """Flatten sections onto self (reference ``arguments.py:168-171``)."""
        for section, content in configuration.items():
            if section in _CONFIG_SECTIONS and isinstance(content, dict):
                for k, v in content.items():
                    setattr(self, k, v)
            else:
                setattr(self, section, content)

    # -- access -------------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}

    def __repr__(self) -> str:  # pragma: no cover
        return f"Arguments({self.to_dict()!r})"

    # -- validation ---------------------------------------------------------
    REQUIRED_FOR_TRAINING: List[str] = [
        "training_type",
        "dataset",
        "model",
        "federated_optimizer",
        "client_num_in_total",
        "client_num_per_round",
        "comm_round",
    ]

    def validate(self, for_training: bool = True) -> "Arguments":
        if for_training:
            missing = [k for k in self.REQUIRED_FOR_TRAINING if not hasattr(self, k)]
            if missing:
                raise ValueError(f"missing required config keys: {missing}")
            if int(self.client_num_per_round) > int(self.client_num_in_total):
                raise ValueError(
                    "client_num_per_round must be <= client_num_in_total "
                    f"({self.client_num_per_round} > {self.client_num_in_total})"
                )
            bl = getattr(self, "population_blocklist", None)
            if bl:
                eligible = int(self.client_num_in_total) - len(set(int(c) for c in bl))
                if eligible < int(self.client_num_per_round):
                    raise ValueError(
                        "population_blocklist leaves only "
                        f"{eligible} eligible clients (< client_num_per_round="
                        f"{self.client_num_per_round})"
                    )
            # selecting FedProx without a mu means "use the default", on
            # EVERY backend — the engine's proximal hook only installs when
            # mu > 0, so injecting here (the one chokepoint all backends
            # pass through) keeps sp/XLA/MPI_PROC training the same objective
            opt = str(getattr(self, "federated_optimizer", "")).lower()
            if opt == "fedprox" and not float(getattr(self, "proximal_mu", 0) or 0):
                from .constants import FEDPROX_DEFAULT_MU

                self.proximal_mu = FEDPROX_DEFAULT_MU
        # population / pacing knobs fail at config time, not as a traceback
        # mid-run when the first round opens (core/population semantics)
        oc = getattr(self, "pacing_overcommit", None)
        if oc is not None and float(oc) < 1.0:
            raise ValueError(f"pacing_overcommit must be >= 1.0 (got {oc})")
        q = getattr(self, "pacing_quorum", None)
        if q is not None and int(q) < 0:
            raise ValueError(f"pacing_quorum must be >= 0 (got {q})")
        pol = str(getattr(self, "selection_policy", "uniform") or "uniform").lower()
        if pol not in ("uniform", "stratified", "importance"):
            raise ValueError(
                f"unknown selection_policy {pol!r} "
                "(expected uniform|stratified|importance)"
            )
        strata = getattr(self, "population_strata", None)
        if strata is not None and int(strata) < 1:
            raise ValueError(f"population_strata must be >= 1 (got {strata})")
        # checkpoint / server-recovery knobs (core/checkpoint.py) — a typo'd
        # value must fail here, not be silently ignored by the bare getattr
        # defaults at the use sites
        for knob in ("checkpoint_dir", "server_checkpoint_dir"):
            d = getattr(self, knob, None)
            if d is not None and not isinstance(d, (str, os.PathLike)):
                raise ValueError(
                    f"{knob} must be a path string (got {type(d).__name__}); "
                    "empty/unset disables checkpointing")
        for knob, floor in (("checkpoint_keep", 1), ("checkpoint_frequency", 1)):
            v = getattr(self, knob, None)
            if v is None:
                continue
            try:
                iv = int(v)
            except (TypeError, ValueError):
                raise ValueError(f"{knob} must be an integer >= {floor} (got {v!r})")
            if iv < floor:
                raise ValueError(f"{knob} must be >= {floor} (got {iv})")
        fsync = getattr(self, "server_journal_fsync", None)
        if fsync is not None:
            if str(fsync).lower() not in JOURNAL_FSYNC_POLICIES:
                raise ValueError(
                    "server_journal_fsync must be one of "
                    f"{JOURNAL_FSYNC_POLICIES} (got {fsync!r})")
        # ingest-pipeline knobs (core/ingest + comm_manager staged path)
        pipe = getattr(self, "ingest_pipeline", None)
        if pipe is not None and not isinstance(pipe, bool):
            if (not isinstance(pipe, str) or pipe.strip().lower() not in
                    ("1", "true", "on", "yes", "0", "false", "off", "no")):
                raise ValueError(
                    "ingest_pipeline must be a bool or on/off string "
                    f"(got {pipe!r})")
        gc_ms = getattr(self, "journal_group_commit_ms", None)
        if gc_ms is not None:
            try:
                gv = float(gc_ms)
            except (TypeError, ValueError):
                raise ValueError(
                    "journal_group_commit_ms must be a number >= 0 "
                    f"(got {gc_ms!r})")
            if gv < 0:
                raise ValueError(
                    f"journal_group_commit_ms must be >= 0 (got {gv})")
        for knob in ("journal_group_commit_max", "ingest_queue_depth"):
            v = getattr(self, knob, None)
            if v is None:
                continue
            try:
                iv = int(v)
            except (TypeError, ValueError):
                raise ValueError(
                    f"{knob} must be an integer >= 1 (got {v!r})")
            if iv < 1:
                raise ValueError(f"{knob} must be >= 1 (got {iv})")
        # chunked resumable-upload knobs (core/distributed/chunking)
        chunk_bytes = getattr(self, "upload_chunk_bytes", None)
        if chunk_bytes is not None:
            try:
                cb = int(chunk_bytes)
            except (TypeError, ValueError):
                raise ValueError(
                    "upload_chunk_bytes must be an integer >= 0 "
                    f"(got {chunk_bytes!r})")
            if cb < 0:
                raise ValueError(
                    f"upload_chunk_bytes must be >= 0 (got {cb})")
        for knob in ("chunk_window", "chunk_buffer_bytes"):
            v = getattr(self, knob, None)
            if v is None:
                continue
            try:
                iv = int(v)
            except (TypeError, ValueError):
                raise ValueError(
                    f"{knob} must be an integer >= 1 (got {v!r})")
            if iv < 1:
                raise ValueError(f"{knob} must be >= 1 (got {iv})")
        # hierarchical fan-in knobs (core/hierarchy) — the plan derives the
        # tree shape from these, so a bad value must fail before any node
        # is built with a different grouping than its peers
        tree = getattr(self, "fan_in_tree", None)
        if tree is not None:
            try:
                tv = int(tree)
            except (TypeError, ValueError):
                raise ValueError(
                    f"fan_in_tree must be one of {FAN_IN_TREE_LEVELS} "
                    f"(got {tree!r})")
            if tv not in FAN_IN_TREE_LEVELS:
                raise ValueError(
                    f"fan_in_tree must be one of {FAN_IN_TREE_LEVELS} "
                    f"(got {tv})")
        fanout = getattr(self, "edge_fanout", None)
        if fanout is not None:
            try:
                fo = int(fanout)
            except (TypeError, ValueError):
                raise ValueError(
                    "edge_fanout must be an integer >= 0 "
                    f"(got {fanout!r})")
            if fo < 0:
                raise ValueError(f"edge_fanout must be >= 0 (got {fo})")
        flush_k = getattr(self, "edge_flush", None)
        if flush_k is not None:
            ok = (isinstance(flush_k, str)
                  and flush_k.strip().lower() == "all")
            if not ok:
                try:
                    fs = float(flush_k)
                    ok = fs > 0
                except (TypeError, ValueError):
                    ok = False
            if not ok:
                raise ValueError(
                    "edge_flush must be 'all' or a positive number of "
                    f"seconds (got {flush_k!r})")
        # observability knobs (core/obs) — bad values fail here so a typo'd
        # interval doesn't silently disable the periodic metrics export
        interval = getattr(self, "obs_metrics_export_interval", None)
        if interval is not None:
            try:
                fv = float(interval)
            except (TypeError, ValueError):
                raise ValueError(
                    f"obs_metrics_export_interval must be a number >= 0 "
                    f"(got {interval!r})")
            if fv < 0:
                raise ValueError(
                    f"obs_metrics_export_interval must be >= 0 (got {fv})")
        slow = getattr(self, "obs_slow_round_factor", None)
        if slow is not None:
            try:
                sv = float(slow)
            except (TypeError, ValueError):
                raise ValueError(
                    f"obs_slow_round_factor must be a number >= 1.0 "
                    f"(got {slow!r})")
            if sv < 1.0:
                raise ValueError(
                    f"obs_slow_round_factor must be >= 1.0 (got {sv})")
        cap = getattr(self, "obs_flight_capacity", None)
        if cap is not None:
            try:
                cv = int(cap)
            except (TypeError, ValueError):
                raise ValueError(
                    f"obs_flight_capacity must be an integer >= 0 "
                    f"(got {cap!r})")
            if cv < 0:
                raise ValueError(
                    f"obs_flight_capacity must be >= 0 (got {cv})")
        port = getattr(self, "obs_export_port", None)
        if port is not None:
            try:
                pv = int(port)
            except (TypeError, ValueError):
                raise ValueError(
                    f"obs_export_port must be an integer in 0..65535 "
                    f"(got {port!r})")
            if not 0 <= pv <= 65535:
                raise ValueError(
                    f"obs_export_port must be in 0..65535 (got {pv})")
        ring = getattr(self, "obs_telemetry_ring", None)
        if ring is not None:
            try:
                rv = int(ring)
            except (TypeError, ValueError):
                raise ValueError(
                    f"obs_telemetry_ring must be an integer >= 1 "
                    f"(got {ring!r})")
            if rv < 1:
                raise ValueError(
                    f"obs_telemetry_ring must be >= 1 (got {rv})")
        flush = getattr(self, "obs_telemetry_flush_s", None)
        if flush is not None:
            try:
                fs = float(flush)
            except (TypeError, ValueError):
                raise ValueError(
                    f"obs_telemetry_flush_s must be a number >= 0 "
                    f"(got {flush!r})")
            if fs < 0:
                raise ValueError(
                    f"obs_telemetry_flush_s must be >= 0 (got {fs})")
        # health-plane knobs (core/obs/health) — a typo'd threshold must
        # fail here, not silently run with the default
        wds = getattr(self, "obs_health_watchdog_s", None)
        if wds is not None:
            try:
                wv = float(wds)
            except (TypeError, ValueError):
                raise ValueError(
                    f"obs_health_watchdog_s must be a number > 0 "
                    f"(got {wds!r})")
            if wv <= 0:
                raise ValueError(
                    f"obs_health_watchdog_s must be > 0 (got {wv})")
        hz = getattr(self, "obs_health_z", None)
        if hz is not None:
            try:
                zv = float(hz)
            except (TypeError, ValueError):
                raise ValueError(
                    f"obs_health_z must be a number > 0 (got {hz!r})")
            if zv <= 0:
                raise ValueError(f"obs_health_z must be > 0 (got {zv})")
        alpha = getattr(self, "obs_health_ewma_alpha", None)
        if alpha is not None:
            try:
                av = float(alpha)
            except (TypeError, ValueError):
                raise ValueError(
                    f"obs_health_ewma_alpha must be a number in (0, 1] "
                    f"(got {alpha!r})")
            if not 0 < av <= 1:
                raise ValueError(
                    f"obs_health_ewma_alpha must be in (0, 1] (got {av})")
        warm = getattr(self, "obs_health_warmup", None)
        if warm is not None:
            try:
                wv = int(warm)
            except (TypeError, ValueError):
                raise ValueError(
                    f"obs_health_warmup must be an integer >= 2 "
                    f"(got {warm!r})")
            if wv < 2:
                raise ValueError(
                    f"obs_health_warmup must be >= 2 (got {wv})")
        # async / buffered-FL knobs (core/async_fl) — a typo'd mode or policy
        # must fail here, not silently run the sync state machine
        mode = getattr(self, "fl_mode", None)
        if mode is not None:
            if str(mode).lower() not in FL_MODES:
                raise ValueError(
                    f"fl_mode must be one of {FL_MODES} (got {mode!r})")
        bs = getattr(self, "async_buffer_size", None)
        if bs is not None:
            try:
                bv = int(bs)
            except (TypeError, ValueError):
                raise ValueError(
                    f"async_buffer_size must be an integer >= 1 (got {bs!r})")
            if bv < 1:
                raise ValueError(f"async_buffer_size must be >= 1 (got {bv})")
            k = getattr(self, "client_num_per_round", None)
            if k is not None and bv > int(k):
                raise ValueError(
                    f"async_buffer_size ({bv}) must not exceed "
                    f"client_num_per_round ({k}): a buffer the active cohort "
                    "cannot fill would only ever flush by deadline")
        spol = getattr(self, "async_staleness_policy", None)
        if spol is not None:
            if str(spol).lower() not in ASYNC_STALENESS_POLICIES:
                raise ValueError(
                    "async_staleness_policy must be one of "
                    f"{ASYNC_STALENESS_POLICIES} (got {spol!r})")
        for knob, floor, kind in (
                ("async_max_staleness", 0, int),
                ("async_hinge_b", 0, int),
                ("async_flush_deadline_s", 0.0, float)):
            v = getattr(self, knob, None)
            if v is None:
                continue
            try:
                cv = kind(v)
            except (TypeError, ValueError):
                raise ValueError(
                    f"{knob} must be a {kind.__name__} >= {floor} (got {v!r})")
            if cv < floor:
                raise ValueError(f"{knob} must be >= {floor} (got {cv})")
        sa = getattr(self, "async_staleness_alpha", None)
        if sa is not None:
            try:
                sav = float(sa)
            except (TypeError, ValueError):
                raise ValueError(
                    f"async_staleness_alpha must be a number > 0 (got {sa!r})")
            if sav <= 0:
                raise ValueError(
                    f"async_staleness_alpha must be > 0 (got {sav})")
        # aggregation-plane knobs (parallel/agg_plane) — a typo'd plane name
        # must not silently fall back to the host loop
        plane = getattr(self, "agg_plane", None)
        if plane is not None:
            if str(plane).lower() not in AGG_PLANES:
                raise ValueError(
                    f"agg_plane must be one of {AGG_PLANES} (got {plane!r})")
        wire = getattr(self, "agg_wire_dtype", None)
        if wire is not None:
            if str(wire).lower() not in AGG_WIRE_DTYPES:
                raise ValueError(
                    f"agg_wire_dtype must be one of {AGG_WIRE_DTYPES} "
                    f"(got {wire!r})")
        mb = getattr(self, "agg_microbatch_clients", None)
        if mb is not None:
            try:
                mv = int(mb)
            except (TypeError, ValueError):
                raise ValueError(
                    f"agg_microbatch_clients must be an integer >= 0 "
                    f"(got {mb!r})")
            if mv < 0:
                raise ValueError(
                    f"agg_microbatch_clients must be >= 0 (got {mv})")
        state = getattr(self, "server_state", None)
        if state is not None:
            if str(state).lower() not in SERVER_STATES:
                raise ValueError(
                    f"server_state must be one of {SERVER_STATES} "
                    f"(got {state!r})")
        # security/privacy stage planes (parallel/sec_plane, core/mpc) — same
        # fail-loud contract: a typo must not silently stay on the host path
        for knob in ("defense_plane", "dp_plane", "secagg_plane"):
            sp = getattr(self, knob, None)
            if sp is not None:
                if str(sp).lower() not in SEC_PLANES:
                    raise ValueError(
                        f"{knob} must be one of {SEC_PLANES} (got {sp!r})")
        for knob, floor in (("server_model_parallel", 0),
                            ("broadcast_shards", 1),
                            ("remesh_max_retries", 1)):
            v = getattr(self, knob, None)
            if v is None:
                continue
            try:
                cv = int(v)
            except (TypeError, ValueError):
                raise ValueError(
                    f"{knob} must be an integer >= {floor} (got {v!r})")
            if cv < floor:
                raise ValueError(f"{knob} must be >= {floor} (got {cv})")
        # a malformed chaos plan should fail at config time, not mid-run when
        # the backend factory first tries to wrap the transport
        if getattr(self, "fault_plan", None):
            raise NotImplementedError(
                "fault_plan drives the message plane, which the port does not "
                "have yet (ROADMAP.md queue A, item 9a: transport and cross-silo FedAvg)")
        return self


def _default_yaml_path(training_type: str, comm_backend: str) -> str:
    base = path.join(path.dirname(__file__), "config")
    if training_type == FEDML_TRAINING_PLATFORM_SIMULATION:
        sub = "simulation_sp" if comm_backend == FEDML_SIMULATION_TYPE_SP else "simulation_xla"
    else:
        sub = training_type
    return path.join(base, sub, "fedml_config.yaml")


def load_arguments(
    training_type: Optional[str] = None, comm_backend: Optional[str] = None
) -> Arguments:
    """Reference ``arguments.py:174-196``: parse CLI, then load YAML config."""
    cmd_args = add_args()
    if not cmd_args.yaml_config_file:
        candidate = _default_yaml_path(
            training_type or FEDML_TRAINING_PLATFORM_SIMULATION,
            comm_backend or FEDML_SIMULATION_TYPE_SP,
        )
        if os.path.exists(candidate):
            cmd_args.yaml_config_file = candidate
    args = Arguments(cmd_args, training_type, comm_backend)
    if not hasattr(args, "rank"):
        args.rank = 0
    return args
