"""The port's process group and multi-process simulator against the JAX
package's (``tests/test_collective.py``, ``tests/test_mpi_proc.py``).

* (a) The collectives over loopback with ranks as threads, world 3: each op
  against numpy; a join with a wrong token refused before anything on that
  connection is unpickled; and the wire shared with the JAX package: a JAX
  hub with port peers and a port hub with JAX peers give ``broadcast`` and
  ``allreduce_mean`` results equal, bit for bit, to an all-JAX group's.
* (b) ``MPIProcessSimulator`` at world 1 (in-process, no sockets) against
  the JAX package's at world 1, on ``mpi_proc_fedavg_mnist_lr`` cut to 2
  rounds with one full batch a client (the engines' shuffles differ), from
  the flax init transplanted: the final params within 2e-5 (the bar of the
  ``sp`` FedAvg tests) and the eval dicts within 2e-4.
* (c) Ranks as threads at world 2 with central DP on: rank 0 noises and
  broadcasts, so every rank holds the same noised params (bit for bit), away
  from a clean run's.
* (d) One spawned ``run_mpi_simulation`` at world 2 on the CPU (one torch
  thread a rank) against the port's world-1 run of the same config, held to
  the JAX tests' bounds: loss within 2e-4, accuracy within 1e-3 (the metrics
  are rounded to 4 decimals, and the two sum in other orders).
* (e) The refusals, with the JAX package's messages.
"""

import copy
import pickle
import socket
import struct
import threading

import jax
import numpy as np
import pytest
import torch
import yaml

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.distributed.collective import ProcessGroup as JProcessGroup
from fedml_tpu_torch.core.distributed import collective as C
from fedml_tpu_torch.core.distributed.collective import ProcessGroup
from fedml_tpu_torch.models import convert
from fedml_tpu_torch.simulation.mpi_proc import MPIProcessSimulator
from netutil import free_port
from test_torch_packed import _filled_init
from test_torch_security_simulation import _reset_singletons

EXAMPLE = "examples/simulation/mpi_proc_fedavg_mnist_lr/fedml_config.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread, so the suite's parallel workers do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_singletons():
    yield
    _reset_singletons()  # the singletons are process-global


def _in_threads(fns, timeout=60):
    """Run each fn in a thread of its own; their results in order (a failure
    is raised here)."""
    out, errors = [None] * len(fns), []

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, fn), daemon=True)
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errors:
        raise errors[0]
    return out


# -- (a) the collectives -------------------------------------------------------------

def test_collectives_against_numpy():
    world, port = 3, free_port()

    def rank(r):
        with ProcessGroup(r, world, addr=("127.0.0.1", port), timeout=30) as pg:
            tree = {"w": torch.full((3,), float(r)), "b": torch.tensor(r, dtype=torch.float32)}
            got = pg.broadcast(tree if r == 0 else None)
            from_2 = pg.broadcast(np.arange(4) * 10 if r == 2 else None, src=2)
            gathered = pg.gather(torch.tensor([r], dtype=torch.int32))
            everyone = pg.allgather({"r": np.asarray([r], np.int32)})
            summed = pg.allreduce_sum({"v": torch.full((2,), float(r))})
            mean = pg.allreduce_mean(torch.full((2,), float(r)), weight=r + 1.0)
            pg.barrier()
            return got, from_2, gathered, everyone, summed, mean

    for r, (got, from_2, gathered, everyone, summed, mean) in enumerate(
            _in_threads([lambda r=r: rank(r) for r in range(world)])):
        assert torch.equal(got["w"], torch.zeros(3)) and float(got["b"]) == 0.0
        assert list(np.asarray(from_2)) == [0, 10, 20, 30]
        assert (gathered is None) == (r != 0)
        if r == 0:
            assert [int(g[0]) for g in gathered] == [0, 1, 2]
        assert [int(e["r"][0]) for e in everyone] == [0, 1, 2]
        assert torch.is_tensor(summed["v"]) and summed["v"].tolist() == [3.0, 3.0]
        # (0*1 + 1*2 + 2*3) / (1+2+3), in the hub's float64 weights
        np.testing.assert_allclose(mean.numpy(), 8.0 / 6.0, rtol=1e-7)
    pg = ProcessGroup(0, 1)
    t = {"a": torch.ones(2)}
    assert pg.broadcast(t) is t and pg.allreduce_sum(t) is t and pg.allgather(t) == [t]
    with pytest.raises(TypeError, match="bf16"):
        C._to_host({"a": torch.ones(2, dtype=torch.bfloat16)})


class _Tripwire:
    """A pickle that records it was loaded."""
    loaded = False

    def __reduce__(self):
        return (_trip, ())


def _trip():
    _Tripwire.loaded = True
    return None


def test_a_wrong_token_is_refused_before_any_pickle(caplog):
    port = free_port()

    def intruder():
        for _ in range(100):
            try:
                s = socket.create_connection(("127.0.0.1", port), timeout=5)
                break
            except OSError:
                threading.Event().wait(0.05)
        blob = pickle.dumps(_Tripwire())
        s.sendall(C._join_preamble("wrong", 1) + struct.pack(">Q", len(blob)) + blob)
        return s

    hub = threading.Thread(target=lambda: results.append(
        ProcessGroup(0, 2, addr=("127.0.0.1", port), timeout=20, token="right")))
    results = []
    hub.start()
    sock = intruder()
    peer = ProcessGroup(1, 2, addr=("127.0.0.1", port), timeout=20, token="right")
    hub.join(20)
    (pg,) = results
    got = _in_threads([lambda: pg.broadcast({"x": torch.ones(2)}), lambda: peer.broadcast()])
    assert torch.equal(got[1]["x"], torch.ones(2)) and not _Tripwire.loaded
    assert "rejected a join attempt" in caplog.text
    sock.close()
    pg.close()
    peer.close()


def _group_results(kinds):
    """broadcast and allreduce_mean over a world of ``kinds`` ("jax" or
    "port" for each rank, rank 0 the hub): each rank's results as numpy."""
    port = free_port()
    rs = np.random.RandomState(5)
    trees = [{"w": rs.randn(3, 4).astype(np.float32), "b": rs.randn(4).astype(np.float32)}
             for _ in kinds]
    weights = [3.0, 5.0, 7.0]

    def rank(r, kind):
        cls = JProcessGroup if kind == "jax" else ProcessGroup
        pg = cls(r, len(kinds), addr=("127.0.0.1", port), timeout=30)
        tree = trees[r] if kind == "jax" else {k: torch.from_numpy(v) for k, v in
                                                trees[r].items()}
        try:
            b = pg.broadcast(tree if r == 0 else None)
            m = pg.allreduce_mean(tree, weight=weights[r])
        finally:
            pg.close()
        return [{k: np.asarray(v) for k, v in t.items()} for t in (b, m)]

    return _in_threads([lambda r=r, k=k: rank(r, k) for r, k in enumerate(kinds)])


def test_port_and_jax_ranks_share_the_wire_bit_for_bit():
    want = _group_results(("jax", "jax", "jax"))
    for kinds in (("jax", "port", "port"), ("port", "jax", "jax")):
        got = _group_results(kinds)
        for r, (g, w) in enumerate(zip(got, want)):
            for gt, wt in zip(g, w):
                for k in wt:
                    assert gt[k].dtype == wt[k].dtype, (kinds, r, k)
                    assert gt[k].tobytes() == wt[k].tobytes(), (kinds, r, k)


# -- (b)-(d) the simulator -----------------------------------------------------------

def _config(rounds=None, batch_size=None, **train):
    with open(EXAMPLE) as f:
        config = yaml.safe_load(f)
    config["data_args"]["data_cache_dir"] = ""
    config["tracking_args"]["log_file_dir"] = ""
    config["device_args"] = {"device_type": "cpu"}
    if rounds is not None:
        config["train_args"]["comm_round"] = rounds
    if batch_size is not None:
        config["train_args"]["batch_size"] = batch_size
    config["train_args"].update(train)
    return config


def _port_rank(config, rank=0, world=1, port=0, jinit=None):
    """One port rank built from ``config`` (args, dataset, model and, with
    ``jinit``, a trainer holding the transplanted flax init)."""
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)),
                                should_init_logs=False)
    args.mpi_rank, args.mpi_world_size, args.pg_master_port = rank, world, port
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, classes)
    trainer = None
    if jinit is not None:
        from fedml_tpu_torch.ml.trainer.trainer_creator import create_model_trainer

        model.to_empty(device="cpu")
        trainer = create_model_trainer(model, args)
        trainer.set_model_params(convert.variables_from_flax(jinit, model, torch.device("cpu")))
    return args, dataset, model, trainer


def _final(sim):
    return {k: v.numpy().copy() for k, v in sim.trainer.get_model_params().items()}


def test_world_one_rank_matches_jax():
    config = _config(rounds=2, batch_size=1024)  # one full batch a client
    jargs = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(config)),
                           should_init_logs=False)
    jargs.mpi_rank, jargs.mpi_world_size = 0, 1
    jdataset, classes = fedml_tpu.data.load(jargs)
    from fedml_tpu.ml.engine import train as jtrain
    from fedml_tpu.simulation.mpi_proc import MPIProcessSimulator as JSim

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "init_variables", _filled_init)
        jsim = JSim(jargs, jdataset, fedml_tpu.models.create(jargs, classes))
    jinit = jax.tree_util.tree_map(np.asarray, jsim.trainer.get_model_params())
    jlast = jsim.train()
    want = convert.params_state_from_flax(jax.tree_util.tree_map(
        np.asarray, jsim.trainer.get_model_params()))
    _reset_singletons()
    args, dataset, model, trainer = _port_rank(config, jinit=jinit)
    sim = MPIProcessSimulator(args, dataset, model, client_trainer=trainer)
    last = sim.train()
    got = _final(sim)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, err_msg=k)
    assert last["round"] == jlast["round"] == 1
    for key in ("test_acc", "test_loss"):
        assert abs(last[key] - jlast[key]) <= 2e-4, (last, jlast)
    assert len(sim.round_times) == 2 and sim.rendezvous_s >= 0.0


@pytest.fixture(scope="module")
def world_one():
    """The port's world-1 run of the example config (3 rounds): (final
    metrics, final params)."""
    sim = MPIProcessSimulator(*_port_rank(_config())[:3])
    last = sim.train()
    _reset_singletons()
    return last, _final(sim)


def test_ranks_hold_the_same_centrally_noised_params(world_one):
    config = _config(enable_dp=True, dp_type="cdp", mechanism_type="gaussian", epsilon=1.0)
    port = free_port()
    ranks = [_port_rank(config, rank=r, world=2, port=port) for r in range(2)]
    sims = _in_threads([lambda a=a: MPIProcessSimulator(*a[:3]) for a in ranks])
    _in_threads([sim.train for sim in sims])
    p0, p1 = (_final(s) for s in sims)
    _, clean = world_one
    for k in p0:
        assert p0[k].tobytes() == p1[k].tobytes(), k
        assert np.abs(p0[k] - clean[k]).max() > 1e-2, k  # noised


def test_spawned_world_two_matches_world_one(world_one, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks inherit it
    m2 = fedml_tpu_torch.run_mpi_simulation(_config(), world_size=2, deadline_s=300)
    m1, _ = world_one
    assert m1["round"] == m2["round"] == 2
    assert abs(m1["test_loss"] - m2["test_loss"]) <= 2e-4, (m1, m2)
    assert abs(m1["test_acc"] - m2["test_acc"]) <= 1e-3, (m1, m2)


# -- (e) the refusals ---------------------------------------------------------------

def test_unsupported_configs_fail_loud():
    args, dataset, model, _ = _port_rank(_config(federated_optimizer="SCAFFOLD"))
    with pytest.raises(NotImplementedError, match="FedAvg/FedProx"):
        MPIProcessSimulator(args, dataset, model)
    _reset_singletons()
    args, dataset, model, _ = _port_rank(_config(enable_defense=True, defense_type="krum"))
    with pytest.raises(NotImplementedError, match="attack/defense"):
        MPIProcessSimulator(args, dataset, model)
