"""The packed ragged-client round of the port against the JAX package's.

* ``pack_round`` and ``s_max_for`` are numpy on both sides: the arrays must
  be equal, bit for bit, for a ragged cohort over 2 epochs.
* ``SeqTrainScheduler`` and ``RuntimeEstimator`` are numpy too: the same
  inputs give the same outputs exactly.
* One packed device round of a ResNet-20 (fp32, 6 clients of 3-37 samples,
  batch 8, 2 epochs, SGD lr 0.1) against the JAX ``build_packed_device_fn``
  at one device (jitted, no mesh), from the same transplanted weights and the
  same schedule: ``wsum`` and ``cnt`` are sample counts and must be equal;
  ``lsum`` rtol 1e-6 and ``acc / wsum`` atol 1e-6 (fp32, sums taken in other
  orders through 28 SGD steps).  The weights are a flax tree of the
  ResNet-20's shapes (``jax.eval_shape`` of its init) filled from a seeded
  numpy stream (``_filled``), which spares the JAX side compiling the init.
  The pregathered stream must give what the per-step gather gives, bit for
  bit.
* bench.py's north-star configuration (``_bench_args``: ResNet-56, bf16
  compute, cifar10, Dirichlet 0.5, ``xla_pack``, batch 64, SGD lr 0.001)
  runs through the entry points on the CPU at a reduced size.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.schedule import RuntimeEstimator as JEstimator, SeqTrainScheduler as JSched
from fedml_tpu.ml.engine import packed as jpacked
from fedml_tpu.models.resnet import resnet20 as jresnet20
from fedml_tpu.simulation.xla.algorithms import create_inmesh_algorithm as jalgo
import fedml_tpu_torch
from fedml_tpu_torch.core.schedule import RuntimeEstimator, SeqTrainScheduler
from fedml_tpu_torch.ml.engine import packed as tpacked
from fedml_tpu_torch.models import convert
from fedml_tpu_torch.models.resnet import resnet20
from fedml_tpu_torch.simulation.xla.algorithms import create_inmesh_algorithm as talgo


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


COUNTS = np.array([13, 0, 37, 3, 21, 8, 16], np.int64)  # one dummy slot
BATCH, EPOCHS = 8, 2


def _cohort():
    """A ragged cohort: client ids, their counts and contiguous row ranges."""
    ids = np.array([5, 2, 0, 6, 3, 1, 4], np.int64)
    starts = np.concatenate([[0], np.cumsum(COUNTS)[:-1]])
    rows = {int(c): np.arange(starts[c], starts[c] + COUNTS[c]) for c in range(len(COUNTS))}
    return ids, COUNTS[ids], rows


def test_pack_round_and_s_max_are_identical():
    ids, counts, rows = _cohort()
    s_max = jpacked.s_max_for(int(COUNTS.max()), len(ids), BATCH, EPOCHS)
    assert tpacked.s_max_for(int(COUNTS.max()), len(ids), BATCH, EPOCHS) == s_max
    # one device (the port's layout), and two devices with a padding slot
    for ids2d, counts2d in ((ids[None], counts[None]),
                            (np.append(ids, 7).reshape(2, 4), np.append(counts, 0).reshape(2, 4))):
        args = (ids2d, counts2d, lambda cid: rows[cid], BATCH, EPOCHS, 3, 1, s_max)
        want, got = jpacked.pack_round(*args), tpacked.pack_round(*args)
        for field in jpacked.PackedSchedule._fields:
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), (ids2d.shape, field)
    assert int(want.n_steps.sum()) == EPOCHS * sum(-(-int(c) // BATCH) for c in counts)


def test_scheduler_and_estimator_are_identical():
    rs = np.random.RandomState(2)
    for n_dev in (1, 3):
        jest, test_ = JEstimator(n_dev), RuntimeEstimator(n_dev)
        jsched, tsched = JSched(n_dev, estimator=jest), SeqTrainScheduler(n_dev, estimator=test_)
        for r in range(4):
            clients = rs.choice(100, 10, replace=False)
            sizes = rs.randint(1, 40, size=10)
            sizes[3] = sizes[7]  # a tie, which argsort must break the same way
            for got, want in zip(tsched.schedule(clients, sizes), jsched.schedule(clients, sizes)):
                assert np.array_equal(got, want), (n_dev, r)
            seconds = 0.5 + 0.01 * int(sizes.sum()) + 0.1 * rs.rand()
            jest.record(0, int(sizes.sum()), seconds)
            test_.record(0, int(sizes.sum()), seconds)
            assert test_.fit_error() == jest.fit_error()
            assert test_.predict(0, 17) == jest.predict(0, 17)
            assert test_.predict_marginal(0, 17) == jest.predict_marginal(0, 17)


def _filled(shapes, seed=0):
    """A flax variables tree of ``shapes`` filled from a seeded numpy stream:
    kernels N(0, 1/fan_in), embeddings N(0, 1/dim), scales 1 + N(0, 0.01),
    biases and BatchNorm running means N(0, 0.01), running variances in
    [0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if leaf in ("bias", "mean"):
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        if leaf == "var":
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        fan = s.shape[-1] if leaf == "embedding" else np.prod(s.shape[:-1])
        return (rng.randn(*s.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _filled_init(module, sample, seed=0):
    """In place of the JAX package's ``init_variables``: ``_filled`` over
    ``jax.eval_shape`` of flax's init, so no init program is compiled (a
    jitted flax init compiles for 1.5-7 s a model)."""
    return dict(_filled(jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(seed), sample, train=False)), seed))


@pytest.fixture(scope="module")
def device_rounds():
    """One packed round on each side; the port's with and without pregather."""
    ids, counts, rows = _cohort()
    n = int(COUNTS.sum())
    rs = np.random.RandomState(0)
    x = rs.randn(n, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 10, size=n).astype(np.int32)
    sched = jpacked.pack_round(ids.reshape(1, -1), counts.reshape(1, -1), lambda c: rows[c],
                               BATCH, EPOCHS, 0, 4, 64)
    args = types.SimpleNamespace(client_optimizer="sgd", learning_rate=0.1, weight_decay=0.0,
                                 momentum=0.0, federated_optimizer="FedAvg")
    jmodel = jresnet20(num_classes=10)
    jvars = _filled(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x[:1]))
    fn = jpacked.build_packed_device_fn(jmodel, args, jalgo(args), BATCH, len(ids))
    acc, wsum, lsum, cnt, _, _ = jax.jit(fn)(
        jvars, (), jnp.asarray(x), jnp.asarray(y),
        *(jnp.asarray(a[0]) for a in sched[:5]), jnp.asarray(sched.n_steps[0]),
        jax.random.PRNGKey(1), None)
    jout = (convert.params_state_from_flax(jax.tree_util.tree_map(np.asarray, acc)),
            float(wsum), float(lsum), float(cnt))

    module = resnet20(num_classes=10, device="meta")
    module.to_empty(device="cpu")
    variables = convert.variables_from_flax(jax.tree_util.tree_map(np.asarray, jvars), module,
                                            torch.device("cpu"))
    one = tpacked.PackedSchedule(*(a[0] for a in sched))
    touts = {}
    for pregather in (False, True):
        tfn = tpacked.build_packed_device_fn(module, args, talgo(args), pregather=pregather)
        acc, wsum, lsum, cnt, ext, outs = tfn(variables, (), torch.from_numpy(x),
                                              torch.from_numpy(y), one, None, len(ids))
        assert ext == 0.0 and outs is None  # FedAvg: no contribution, no output
        touts[pregather] = (acc, wsum, lsum, cnt)
    return jout, touts


def test_packed_round_counts_are_exact(device_rounds):
    (_, jwsum, _, jcnt), touts = device_rounds
    _, wsum, _, cnt = touts[False]
    assert wsum == jwsum == float(COUNTS.sum())
    assert cnt == jcnt == float(EPOCHS * COUNTS.sum())


def test_packed_round_matches_jax(device_rounds):
    (jacc, jwsum, jlsum, _), touts = device_rounds
    acc, wsum, lsum, _ = touts[False]
    np.testing.assert_allclose(float(lsum), jlsum, rtol=1e-6)
    assert sorted(acc) == sorted(jacc)
    for name, a in acc.items():
        np.testing.assert_allclose(a.numpy() / wsum, jacc[name] / jwsum, atol=1e-6,
                                   err_msg=name)


def test_pregather_equals_per_step_gather(device_rounds):
    _, touts = device_rounds
    (acc, wsum, lsum, cnt), (pacc, pwsum, plsum, pcnt) = touts[False], touts[True]
    assert (wsum, cnt, float(lsum)) == (pwsum, pcnt, float(plsum))
    for name in acc:
        assert torch.equal(acc[name], pacc[name]), name


def test_device_fn_refuses_unported_hooks():
    module = resnet20(device="meta")
    args = types.SimpleNamespace(client_optimizer="sgd", learning_rate=0.1)
    # the trust path's hooks (local DP, the update stack) are ported: they build
    assert callable(tpacked.build_packed_device_fn(module, args, talgo(args),
                                                   post_train=lambda tree, gen: tree,
                                                   capture_updates=True))
    with pytest.raises(ValueError, match="xla_stream"):
        tpacked.build_packed_device_fn(module, args, talgo(args), stream="fori")


BENCH_CONFIG = {  # bench.py's _bench_args(1), cut: 8 clients, 4 a round, 2 rounds
    "common_args": {"training_type": "simulation", "random_seed": 0, "run_id": "bench"},
    "data_args": {"dataset": "cifar10", "data_cache_dir": "./fedml_data",
                  "partition_method": "hetero", "partition_alpha": 0.5,
                  "synthetic_train_size": 256},
    "model_args": {"model": "resnet56", "compute_dtype": "bf16"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 8,
                   "client_num_per_round": 4, "xla_pack": True, "comm_round": 2, "epochs": 1,
                   "batch_size": 64, "client_optimizer": "sgd", "learning_rate": 0.001},
    "validation_args": {"frequency_of_the_test": 0},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "XLA"},
}


def test_bench_configuration_runs_through_the_entry_points():
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(BENCH_CONFIG)),
                                should_init_logs=False)
    device = fedml_tpu_torch.device.get_device(args)
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, classes)
    runner = fedml_tpu_torch.FedMLRunner(args, device, dataset, model)
    runner.run()
    sim = runner.runner.sim
    assert sim.packed and sim.x_all.dtype is torch.bfloat16 and model.dtype is torch.bfloat16
    assert len(model.block_names) == 27 and args.dataset_is_synthetic  # ResNet-56
    assert len(sim.round_losses) == 2 and all(np.isfinite(sim.round_losses))
    assert all(v.dtype is torch.float32 for v in sim.variables.values())
