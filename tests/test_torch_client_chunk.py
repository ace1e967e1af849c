"""``xla_client_chunk``: the padded round trains k clients at once
(``ml.engine.train.build_chunked_local_train``, ``torch.func.vmap`` over k
parameter sets), the port against the JAX package's ``XLASimulator`` with the
same knob and against its own unchunked round.

* ``FlashAttention`` under ``torch.func.vmap``: output and gradients equal the
  per-client loop's (the plain versions on the CPU: the same math on the same
  rows, so exactly), through one call a chunk, not one a client.
* The chunked padded round against JAX's chunked round on a one-device CPU
  mesh, ``lr`` and a 1-layer TransformerLM (d 32, L 80 tokens of shakespeare;
  JAX attends through its reference on the CPU): one full batch per epoch,
  as the engines shuffle differently; the same cohorts and layout each round,
  globals within ATOL 5e-5 (fp32, sums in other orders; measured 2.2e-8 on
  ``lr`` and 2.4e-7 on the TransformerLM).
* Chunk k against chunk 1 in the port, per client optimizer: within
  CHUNK_ATOL (SGD 1e-6, measured 2.2e-8 and with momentum 1.5e-8; adam 2e-5,
  measured 1.9e-6 for adam and 1.8e-6 for adamw, whose step divides the
  roundoff of tiny gradients by their own root).
* A chunk holding clients with no valid row in a step, and one with none at
  all: each client's variables, step count and adam state (within 1e-6),
  and its mean loss (1e-5, a mean of order 1; measured 1.4e-6 on the
  ResNet-20) against its own unchunked run (the per-client mask on params,
  optimizer state and the BatchNorm averages).
* FedProx, SCAFFOLD and FedDyn (grad hooks on the stacked leaves), BatchNorm
  (resnet20, 2 clients of 8 images) and dropout (``cnn``: each client's masks
  from its own generator) against chunk 1 within 1e-6 (measured at most
  2.4e-7, the ResNet-20's; the round losses equal); the ``rnn`` refusal; the
  divisor rule and its warning.
"""

import copy
import logging

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.models.transformer import TransformerConfig as JCfg, TransformerLM as JLM
from fedml_tpu.parallel.mesh import create_fl_mesh
from fedml_tpu.simulation.xla import fed_sim as jfed_sim
from fedml_tpu_torch.ml.engine import train as engine
from fedml_tpu_torch.models import convert
from fedml_tpu_torch.models.resnet import resnet20
from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from fedml_tpu_torch.ops import flash_attention as fa
from test_torch_packed import _filled_init
from test_torch_simulation import _place_replicated


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = 5e-5
CHUNK_ATOL = {"sgd": 1e-6, "momentum": 1e-6, "adam": 2e-5, "adamw": 2e-5}
CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "mnist", "partition_method": "hetero", "partition_alpha": 0.5,
                  "synthetic_train_size": 240},
    "model_args": {"model": "lr"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 8,
                   "client_num_per_round": 4, "comm_round": 2, "epochs": 1,
                   "batch_size": 16, "client_optimizer": "sgd", "learning_rate": 0.05},
    "validation_args": {"frequency_of_the_test": 0},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "XLA"},
}
CFG = dict(vocab_size=96, d_model=32, n_heads=2, n_layers=1, d_ff=64)


def _config(**sections):
    config = copy.deepcopy(CONFIG)
    for section, knobs in sections.items():
        config[section].update(knobs)
    return config


def _port_sim(config, model=None):
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)),
                                should_init_logs=False)
    device = fedml_tpu_torch.device.get_device(args)
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = model if model is not None else fedml_tpu_torch.models.hub.create(args, classes)
    return fedml_tpu_torch.FedMLRunner(args, device, dataset, model)


def _final(config, model=None):
    runner = _port_sim(config, model)
    runner.run()
    sim = runner.runner.sim
    return {k: v.detach().clone() for k, v in sim.variables.items()}, sim


def _max_diff(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def test_vmapped_flash_attention_equals_the_client_loop(monkeypatch):
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for name, key in (("flash_forward_plain", "fwd"), ("flash_bwd_dq_plain", "dq"),
                      ("flash_bwd_dkv_plain", "dkv")):
        fn = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _fn=fn, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1), _fn(*a, **kw))[1])
    gen = torch.Generator().manual_seed(0)
    k, B, L, H, D = 3, 2, 24, 2, 8
    q, kk, v = (torch.randn(k, B, L, H, D, generator=gen, requires_grad=True)
                for _ in range(3))
    w = torch.randn(k, B, L, H, D, generator=gen)
    for causal in (True, False):
        o = torch.func.vmap(lambda a, b, c: fa.flash_attention(a, b, c, causal))(q, kk, v)
        (o * w).sum().backward()
        assert calls == {"fwd": 1, "dq": 1, "dkv": 1}  # one call for the k clients
        got = [o.detach()] + [t.grad for t in (q, kk, v)]
        for t in (q, kk, v):
            t.grad = None
        o2 = torch.stack([fa.flash_attention(q[i], kk[i], v[i], causal) for i in range(k)])
        (o2 * w).sum().backward()
        assert calls == {"fwd": 1 + k, "dq": 1 + k, "dkv": 1 + k}
        want = [o2.detach()] + [t.grad for t in (q, kk, v)]
        for g, h in zip(got, want):
            torch.testing.assert_close(g, h, rtol=0, atol=0)
        for t in (q, kk, v):
            t.grad = None
        calls.update(fwd=0, dq=0, dkv=0)
    # an unbatched key/value (a vmap in_dim of None) is broadcast
    o3 = torch.func.vmap(lambda a: fa.flash_attention(a, kk[0], v[0], True))(q)
    torch.testing.assert_close(o3[1], fa.flash_attention(q[1], kk[0], v[0], True))


def _jax_pair(config, jmodel=None, tmodel=None):
    """The JAX XLASimulator on a one-device mesh and the port's round sim,
    both from the JAX init; each round's cohort, layout and global recorded."""
    jargs = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(config)),
                           should_init_logs=False)
    jdataset, classes = fedml_tpu.data.data_loader.load(jargs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfed_sim, "init_variables", _filled_init)
        jsim = jfed_sim.XLASimulator(
            jargs, jdataset, jmodel or fedml_tpu.models.hub.create(jargs, classes),
            mesh=create_fl_mesh(devices=jax.devices()[:1]))
    _place_replicated(jsim)
    trun = _port_sim(config, tmodel)
    tsim = trun.runner.sim
    tsim.variables = convert.variables_from_flax(
        jax.tree_util.tree_map(np.asarray, jsim.variables), tsim.module, tsim.device)
    logs = []
    for sim, to_np in ((jsim, lambda s: convert.variables_from_flax(
            jax.tree_util.tree_map(np.asarray, s.variables), tsim.module, "cpu")),
                       (tsim, lambda s: {k: v.clone() for k, v in s.variables.items()})):
        log = {"layouts": [], "globals": []}
        schedule, round_end = sim._schedule, sim.algo.host_round_end

        def scheduled(sampled, _s=schedule, _log=log):
            ids, real = _s(sampled)
            _log["layouts"].append(([int(c) for c in ids], [float(r) for r in real]))
            return ids, real

        def ended(*a, _e=round_end, _log=log, _sim=sim, _np=to_np):
            out = _e(*a)
            _log["globals"].append(_np(_sim))
            return out

        sim._schedule, sim.algo.host_round_end = scheduled, ended
        logs.append(log)
    jsim.train()
    trun.run()
    return logs


@pytest.mark.parametrize("model", ["lr", "transformer"])
def test_chunked_round_matches_jax_chunked_round(model):
    if model == "lr":
        config = _config(train_args={"xla_client_chunk": 2, "batch_size": 64})
        jlog, tlog = _jax_pair(config)
    else:
        config = _config(data_args={"dataset": "shakespeare", "partition_method": "homo",
                                    "synthetic_train_size": 160},
                         model_args={"model": "transformer"},
                         train_args={"xla_client_chunk": 2, "batch_size": 32,
                                     "learning_rate": 0.1})
        jlog, tlog = _jax_pair(config, JLM(JCfg(**CFG)),
                               TransformerLM(TransformerConfig(**CFG), device="meta"))
    assert len(tlog["layouts"]) == 2 and tlog["layouts"] == jlog["layouts"]
    for r, (tv, jv) in enumerate(zip(tlog["globals"], jlog["globals"])):
        assert sorted(tv) == sorted(jv)
        for name in tv:
            torch.testing.assert_close(tv[name], jv[name], rtol=0, atol=ATOL,
                                       msg=f"round {r} {name}")


@pytest.mark.parametrize("opt", sorted(CHUNK_ATOL))
def test_chunk_k_against_chunk_1(opt):
    knobs = {"sgd": {}, "momentum": {"momentum": 0.9, "weight_decay": 1e-3},
             "adam": {"client_optimizer": "adam", "learning_rate": 0.01, "weight_decay": 1e-2},
             "adamw": {"client_optimizer": "adamw", "learning_rate": 0.01,
                       "weight_decay": 1e-2}}[opt]
    ref, _ = _final(_config(train_args=knobs))
    got, sim = _final(_config(train_args=dict(knobs, xla_client_chunk=4)))
    assert sim._resolve_chunk(4) == 4
    assert _max_diff(got, ref) <= CHUNK_ATOL[opt]


@pytest.mark.parametrize("model", ["lr_adam", "resnet20_bn"])
def test_clients_without_a_valid_row_keep_their_state(model):
    """Clients of 0, 3 and 20 valid rows of 24 (batch 8: the 3-row client
    has all-padding batches) in one chunk, each against its own run."""
    if model == "lr_adam":
        module = fedml_tpu_torch.models.hub.create(
            fedml_tpu_torch.Arguments.from_dict(_config()), 10)
        args = fedml_tpu_torch.Arguments.from_dict(_config(train_args={
            "client_optimizer": "adam", "learning_rate": 0.01}))
        shape = (24, 28, 28)
    else:
        module = resnet20(num_classes=10, norm="bn", device="meta")
        args = fedml_tpu_torch.Arguments.from_dict(_config(train_args={"learning_rate": 0.01}))
        shape = (24, 8, 8, 3)
    variables = engine.init_variables(module, torch.device("cpu"), seed=0)
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.randn(3, *shape).astype(np.float32))
    y = torch.as_tensor(rs.randint(0, 10, size=(3, 24)))
    n_valid, seeds = [0, 3, 20], [(0, 0, c) for c in range(3)]
    chunked = engine.build_chunked_local_train(module, args, 8, 24, epochs=2)(
        variables, x, y, n_valid, seeds)
    single = engine.build_local_train(module, args, 8, 24, epochs=2)
    for c, got in enumerate(chunked):
        want = single(variables, x[c], y[c], n_valid[c], seed=seeds[c])
        assert got.steps == want.steps and got.seen == want.seen
        assert _max_diff(got.variables, want.variables) <= 1e-6, c
        torch.testing.assert_close(got.loss, want.loss, rtol=0, atol=1e-5)
        assert sorted(got.opt_state) == sorted(want.opt_state)
        for i, state in want.opt_state.items():
            for key, t in state.items():
                torch.testing.assert_close(got.opt_state[i][key], t, rtol=0, atol=1e-6)
    assert chunked[0].steps == 0 and chunked[0].opt_state == {}
    assert _max_diff(chunked[0].variables, variables) == 0.0
    assert 0 < chunked[1].steps < chunked[2].steps


@pytest.mark.parametrize("member", ["fedprox", "scaffold", "feddyn"])
def test_grad_hooks_under_chunk(member):
    knobs = {"fedprox": {"federated_optimizer": "FedProx", "proximal_mu": 0.1},
             "scaffold": {"federated_optimizer": "SCAFFOLD"},
             "feddyn": {"federated_optimizer": "FedDyn", "feddyn_alpha": 0.1}}[member]
    ref, rsim = _final(_config(train_args=knobs))
    got, sim = _final(_config(train_args=dict(knobs, xla_client_chunk=2)))
    assert _max_diff(got, ref) <= 1e-6
    if sim.client_state is not None:
        assert _max_diff(sim.client_state, rsim.client_state) <= 1e-6


@pytest.mark.parametrize("model", ["resnet20_bn", "cnn"])
def test_batch_stats_and_dropout_under_chunk(model):
    if model == "resnet20_bn":
        sections = {"data_args": {"dataset": "cifar10", "synthetic_train_size": 16},
                    "model_args": {"model": "resnet20", "model_norm": "bn"},
                    "train_args": {"client_num_in_total": 2, "client_num_per_round": 2,
                                   "comm_round": 1, "batch_size": 4, "learning_rate": 0.001}}
    else:
        sections = {"data_args": {"synthetic_train_size": 96},
                    "train_args": {"comm_round": 1}, "model_args": {"model": "cnn"}}
    ref, rsim = _final(_config(**sections))
    sections["train_args"] = dict(sections["train_args"], xla_client_chunk=2)
    got, sim = _final(_config(**sections))
    assert _max_diff(got, ref) <= 1e-6
    # the dropout masks are each client's own: the losses agree too
    assert sim.round_losses == pytest.approx(rsim.round_losses, abs=1e-6)
    if model == "resnet20_bn":
        stats = [k for k in got if convert.is_batch_stat(k)]
        assert stats and all(not torch.equal(got[k], rsim.variables[k] * 0) for k in stats)


def test_rnn_family_is_refused():
    config = _config(data_args={"dataset": "shakespeare", "synthetic_train_size": 80},
                     model_args={"model": "rnn"}, train_args={"xla_client_chunk": 2})
    with pytest.raises(NotImplementedError, match="item 6c's rest"):
        _port_sim(config)
    _port_sim(_config(data_args={"dataset": "shakespeare", "synthetic_train_size": 80},
                      model_args={"model": "rnn"}, train_args={"xla_client_chunk": 1}))


def test_chunk_is_the_largest_divisor_with_a_warning(caplog):
    sim = _port_sim(_config(train_args={"xla_client_chunk": 3})).runner.sim
    with caplog.at_level(logging.WARNING):
        assert sim._resolve_chunk(4) == 2 and sim._resolve_chunk(4) == 2
        assert sim._resolve_chunk(9) == 3 and sim._resolve_chunk(2) == 2
    warned = [r.getMessage() for r in caplog.records if "xla_client_chunk" in r.getMessage()]
    assert warned == ["xla_client_chunk=3 does not divide clients/device=4; using 2",
                      "xla_client_chunk=3 does not divide clients/device=2; using 2"]
