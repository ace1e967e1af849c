"""The analysis attacks and the centralized baseline of the port against the
JAX package's.

* ``dlg_attack`` (L2 gradient matching) and ``invert_gradient_attack``
  (cosine matching and the NHWC total-variation prior) on the ``lr`` model
  at MNIST's shapes and on a ``cnn`` (``CNN_DropOut``) at 8x8x1, so the
  prior acts: the same flax weights (transplanted), the same intercepted
  update (one SGD step on 4 samples) and JAX's own starting draw fed in,
  5 descent steps.  The reconstructions agree elementwise within 2e-5 of
  their largest entry (fp32 second derivatives summed in other orders; the
  largest reading 3.3e-6).
* ``reveal_labels_from_update``: order and mask equal to JAX's, on the
  ``lr`` model and on eleven dense layers (``Dense_0`` ... ``Dense_10``,
  whose flatten order puts ``Dense_10`` before ``Dense_5``), where both
  packages pick the same leaf: the decoy without ``head_path``, the head
  with it.
* The round simulator on ``xla_invert_gradient_mnist_lr`` against the JAX
  ``XLASimulator`` on a one-device mesh, from the same init (transplanted):
  ``invert_gradient`` on the padded round (one full batch a client, so the
  engines' shuffles cannot matter) and ``revealing_labels_from_gradients``
  on the packed round.  Each analysed round picks the same victim (JAX's
  byzantine draw is numpy in both packages), its intercepted row agrees
  within 2e-5 (the trust path's bar) and the result agrees: the
  reconstruction, from JAX's draw, within rtol 1e-4 and atol 1e-5 after the
  example's 50 steps; the revealed labels equal.  With each of the three
  attacks on each round the global model is a clean run's, bit for bit.
* A second derivative through the flash-attention wrappers raises, and so
  does the attacks' gradient function on a model that attends.
* ``CentralizedTrainer`` against JAX's on ``lr``, one full batch an epoch:
  the final params within 2e-5 and the eval dicts within 2e-4.
"""

import copy

import jax
import numpy as np
import pytest
import torch
import yaml

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.security import attack_funcs as JA
from fedml_tpu.core.security.fedml_attacker import FedMLAttacker as JAttacker
from fedml_tpu.models.cnn import CNN_DropOut as JCNN
from fedml_tpu.models.linear import LogisticRegression as JLR
from fedml_tpu.parallel.mesh import create_fl_mesh
from fedml_tpu.simulation.xla import fed_sim as jfed_sim
from fedml_tpu_torch.core.security import attack_funcs as TA
from fedml_tpu_torch.core.security.fedml_attacker import FedMLAttacker
from fedml_tpu_torch.models import convert
from fedml_tpu_torch.models.cnn import CNN_DropOut
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.ops import flash_attention as fa
from test_torch_packed import _filled, _filled_init
from test_torch_security_simulation import _reset_singletons
from test_torch_simulation import _place_replicated

CPU = torch.device("cpu")
EXAMPLE = "examples/simulation/xla_invert_gradient_mnist_lr/fedml_config.yaml"
ANALYSES = ("invert_gradient", "dlg", "revealing_labels_from_gradients")
# a reconstruction against JAX's, elementwise, relative to its largest entry:
# fp32 gradients of gradients summed in other orders, five descent steps (DLG's
# L2 steps on the lr model move y by 16 and read 3.3e-6)
RECONSTRUCTION_RTOL = 2e-5


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


def _port_tree(jtree, module):
    return convert.variables_from_flax(jax.tree_util.tree_map(np.asarray, jtree), module, CPU)


# -- the attack functions ------------------------------------------------------------


_VICTIMS = {}


def _flax_tree(variables):
    """The flax variables tree of a port variables dict (each leaf at its
    flax path, its axes in flax's order)."""
    params = {}
    for name, t in variables.items():
        path, perm = convert.flax_leaf(name, t.dim())
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.detach().numpy().transpose(perm)
    return {"params": params}


def _victim(name):
    """(JAX model, port module, flax weights, the update of one SGD step of
    lr 0.1 on 4 seeded samples, the input shape), made once a model.  The
    weights are a flax tree of the model's shapes (``jax.eval_shape`` of its
    init) filled from a seeded numpy stream, and the step is the port's
    (torch autograd), so the JAX side compiles only the attacks."""
    if name not in _VICTIMS:
        _VICTIMS[name] = _make_victim(name)
    return _VICTIMS[name]


def _make_victim(name):
    if name == "lr":
        jm, tm, shape = JLR(output_dim=10), LogisticRegression(784, 10, device="meta"), \
            (4, 28, 28, 1)
    else:
        jm, tm, shape = JCNN(only_digits=True), CNN_DropOut(in_hw=(8, 8), device="meta"), \
            (4, 8, 8, 1)
    tm.to_empty(device="cpu")
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    y = rs.randint(0, 10, shape[0])
    variables = _filled(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x[:1]))
    params = {n: p.requires_grad_() for n, p in _port_tree(variables, tm).items()}
    with TA._eval_mode(tm):
        logits = torch.func.functional_call(tm, params, (torch.from_numpy(x),))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(params.values()))
    update = _flax_tree({n: p - 0.1 * g for (n, p), g in zip(params.items(), grads)})
    return jm, tm, variables, update, shape


def _jax_draw(key, x_shape, num_classes):
    """JAX's starting point of a reconstruction from ``key``
    (``invert_gradient``: x from the first split, y logits from the second)."""
    kx, ky = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.normal(kx, x_shape))),
            torch.from_numpy(np.array(jax.random.normal(ky, (x_shape[0], num_classes)))))


@pytest.mark.parametrize("model", ["lr", "cnn"])
@pytest.mark.parametrize("attack", ["dlg_attack", "invert_gradient_attack"])
def test_reconstruction_matches_jax(attack, model):
    jm, tm, variables, update, shape = _victim(model)
    x_shape = (1,) + shape[1:]
    key = jax.random.PRNGKey(7)
    jx, jy = getattr(JA, attack)(jm, variables, update, x_shape, 10, key, lr_client=0.1,
                                 steps=5, lr_attack=0.1)
    init = _jax_draw(key, x_shape, 10)
    px, py = getattr(TA, attack)(tm, _port_tree(variables, tm), _port_tree(update, tm), x_shape,
                                 10, lr_client=0.1, steps=5, lr_attack=0.1, init=init)
    assert px.shape == x_shape and py.shape == (1, 10)
    # the descent lowered the objective it matches
    match = "cosine" if attack == "invert_gradient_attack" else "l2"
    tv = 1e-2 if match == "cosine" else 0.0
    losses = [TA.update_match_loss(tm, _port_tree(variables, tm), _port_tree(update, tm), x, y,
                                   0.1, match, tv) for x, y in (init, (px, py))]
    assert losses[1] < losses[0], losses
    for got, want in ((px, jx), (py, jy)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=RECONSTRUCTION_RTOL * np.abs(want).max())


def _eleven_layers():
    """The JAX tests' eleven dense layers (``tests/test_security_zoo.py``):
    ``Dense_5`` (a decoy) and ``Dense_10`` (the head) have (10,) biases, the
    head's bias gradient negative for classes {2, 7}, the decoy's for {0, 1}.
    Returns the flax trees and the port's (dense weights transposed)."""
    rng = np.random.RandomState(0)
    widths = [32, 28, 24, 20, 16, 10, 18, 14, 12, 16, 10]
    params, update, tparams, tupdate = {}, {}, {}, {}
    in_dim = 8
    for i, w in enumerate(widths):
        kernel = rng.randn(in_dim, w).astype(np.float32)
        bias = rng.randn(w).astype(np.float32)
        k_grad = 0.01 * rng.randn(in_dim, w).astype(np.float32)
        b_grad = np.abs(rng.randn(w)).astype(np.float32) * 0.1 + 0.01
        if i == 10:
            b_grad[[2, 7]] = -0.5
        if i == 5:
            b_grad[[0, 1]] = -0.5
        params[f"Dense_{i}"] = {"kernel": kernel, "bias": bias}
        update[f"Dense_{i}"] = {"kernel": kernel - 0.1 * k_grad, "bias": bias - 0.1 * b_grad}
        for tree, flax in ((tparams, params), (tupdate, update)):
            tree[f"Dense_{i}.weight"] = torch.from_numpy(flax[f"Dense_{i}"]["kernel"].T.copy())
            tree[f"Dense_{i}.bias"] = torch.from_numpy(flax[f"Dense_{i}"]["bias"])
        in_dim = w
    return {"params": params}, {"params": update}, tparams, tupdate


@pytest.mark.parametrize("head_path", [None, ("Dense_10", "bias"), "Dense_10/bias"])
def test_revealed_labels_match_jax_at_eleven_layers(head_path):
    jv, ju, tv, tu = _eleven_layers()
    jorder, jpresent = JA.reveal_labels_from_update(jv, ju, 10, lr_client=0.1,
                                                    head_path=head_path)
    order, present = TA.reveal_labels_from_update(tv, tu, 10, lr_client=0.1,
                                                  head_path=head_path)
    assert order.tolist() == np.asarray(jorder).tolist()
    assert present.tolist() == np.asarray(jpresent).tolist()
    # the fallback lands on the decoy in both packages, head_path on the head
    assert present.nonzero().flatten().tolist() == ([0, 1] if head_path is None else [2, 7])


def test_revealed_labels_match_jax_on_lr_and_refuse_bad_paths():
    jm, tm, variables, update, _ = _victim("lr")
    jorder, jpresent = JA.reveal_labels_from_update(variables, update, 10, lr_client=0.1)
    order, present = TA.reveal_labels_from_update(_port_tree(variables, tm),
                                                  _port_tree(update, tm), 10, lr_client=0.1)
    assert order.tolist() == np.asarray(jorder).tolist()
    assert present.tolist() == np.asarray(jpresent).tolist() and present.any()
    _, _, tv, tu = _eleven_layers()
    with pytest.raises(ValueError, match="not found"):
        TA.reveal_labels_from_update(tv, tu, 10, head_path=("Dense_99", "bias"))
    with pytest.raises(ValueError, match="BIAS"):
        TA.reveal_labels_from_update(tv, tu, 10, head_path=("Dense_10", "kernel"))
    with pytest.raises(ValueError, match="no \\(7,\\) bias leaf"):
        TA.reveal_labels_from_update(tv, tu, 7)


def test_attacker_keeps_its_results():
    """``reconstruct_data`` runs only for dlg; ``analyze_update`` dispatches
    the three attacks and keeps each result on the instance; a
    reconstruction's start is the attacker's own draw, the same for the
    same seed."""
    _, tm, variables, update, shape = _victim("cnn")
    tv, tu = _port_tree(variables, tm), _port_tree(update, tm)
    x_shape = (2,) + shape[1:]
    att = FedMLAttacker.get_instance()
    recs = []
    for attack in ("dlg", "dlg", "invert_gradient", "revealing_labels_from_gradients"):
        att.init(fedml_tpu_torch.Arguments.from_dict(
            {"enable_attack": True, "attack_type": attack, "random_seed": 3,
             "dlg_steps": 3, "learning_rate": 0.1}))
        assert att.is_analysis_attack()
        if attack != "dlg":
            assert att.reconstruct_data(tm, tv, tu, x_shape, 10) is None
        out = att.analyze_update(tm, tv, tu, x_shape, 10)
        if attack == "revealing_labels_from_gradients":
            assert out is att.last_revealed_labels and out[0].shape == (10,)
        else:
            assert out is att.last_reconstruction and out[0].shape == x_shape
            recs.append(out)
    assert torch.equal(recs[0][0], recs[1][0])  # one seed, one draw
    assert tm.training  # the module's mode is restored


# -- the round simulator's hook ------------------------------------------------------


def _example(kind):
    with open(EXAMPLE) as f:
        config = yaml.safe_load(f)
    config["data_args"]["data_cache_dir"] = ""
    config["tracking_args"]["log_file_dir"] = ""
    config["device_args"] = {"device_type": "cpu"}
    if kind == "packed":
        config["train_args"]["xla_pack"] = True
    else:
        config["train_args"]["batch_size"] = 256  # one full batch a client
    return config


def _port_round_run(config, init=None, draws=None):
    """The port's run of ``config``: (simulator, global params after each
    round, [(prev global, row)] of each analysed round, the attacker)."""
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)),
                                should_init_logs=False)
    dataset, classes = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.models.hub.create(args, classes)
    runner = fedml_tpu_torch.FedMLRunner(args, CPU, dataset, model)
    sim = runner.runner.sim
    if init is not None:
        sim.variables = convert.variables_from_flax(init, model, CPU)
    states, rows = [], []
    sync = sim._sync

    def synced():
        sync()
        states.append({k: v.clone() for k, v in sim.variables.items()})

    sim._sync = synced
    att = FedMLAttacker.get_instance()
    if att.is_analysis_attack():
        analyze = att.analyze_update

        def analyzed(module, variables, row, x_shape, num_classes):
            rows.append(({k: v.clone() for k, v in variables.items()},
                         {k: v.clone() for k, v in row.items()}))
            return analyze(module, variables, row, x_shape, num_classes)

        att.analyze_update = analyzed
    with pytest.MonkeyPatch.context() as mp:
        if draws is not None:  # JAX's starting draws in place of the attacker's
            invert = TA.invert_gradient
            mp.setattr(TA, "invert_gradient",
                       lambda *a, **kw: invert(*a, **dict(kw, init=draws.pop(0))))
        runner.run()
    return sim, states, rows, att


def _jax_round_run(config):
    """The JAX run of ``config`` on a one-device mesh: (its init, [(prev
    global, row, result, key)] of each analysed round, in the port's names)."""
    jargs = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(config)),
                           should_init_logs=False)
    dataset, classes = fedml_tpu.data.data_loader.load(jargs)
    model = fedml_tpu.models.hub.create(jargs, classes)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfed_sim, "init_variables", _filled_init)
        jsim = jfed_sim.XLASimulator(jargs, dataset, model,
                                     mesh=create_fl_mesh(devices=jax.devices()[:1]))
    _place_replicated(jsim)
    init = jax.tree_util.tree_map(np.asarray, jsim.variables)
    att, analysed, keys = JAttacker.get_instance(), [], []
    analyze = att.analyze_update
    invert = JA.invert_gradient

    def keyed(grad_fn, target, x_shape, y_shape, key, **kw):
        keys.append((key, x_shape, y_shape[-1]))
        return invert(grad_fn, target, x_shape, y_shape, key, **kw)

    def analyzed(module, variables, row, x_shape, num_classes):
        out = analyze(module, variables, row, x_shape, num_classes)
        analysed.append([convert.params_state_from_flax(jax.tree_util.tree_map(np.asarray, t))
                         for t in (variables, row)] + [jax.tree_util.tree_map(np.asarray, out)])
        return out

    att.analyze_update = analyzed
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "invert_gradient", keyed)
        jsim.train()
    draws = [_jax_draw(k, xs, c) for k, xs, c in keys]
    _reset_singletons()
    return init, analysed, draws


@pytest.mark.parametrize("kind,attack", [("padded", "invert_gradient"),
                                         ("packed", "revealing_labels_from_gradients")])
def test_round_analysis_matches_jax(kind, attack):
    config = _example(kind)
    config["attack_args"]["attack_type"] = attack
    config["validation_args"]["frequency_of_the_test"] = 0  # no eval: not compared here
    init, janalysed, draws = _jax_round_run(config)
    sim, _, rows, att = _port_round_run(config, init, draws)
    assert len(rows) == len(janalysed) == config["train_args"]["comm_round"]
    assert sim.analysis_victims and all(v in range(8) for v in sim.analysis_victims)
    for (prev, row), (jprev, jrow, _) in zip(rows, janalysed):
        for k in prev:
            np.testing.assert_allclose(prev[k].numpy(), jprev[k], atol=2e-5, err_msg=k)
            np.testing.assert_allclose(row[k].numpy(), jrow[k], atol=2e-5, err_msg=k)
    jout = janalysed[-1][2]
    if attack == "revealing_labels_from_gradients":
        order, present = att.last_revealed_labels
        assert present.tolist() == jout[1].tolist() and present.any()
        assert order.tolist() == jout[0].tolist()
    else:
        x, y = att.last_reconstruction
        np.testing.assert_allclose(x.numpy(), jout[0], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(y.numpy(), jout[1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("attack", ANALYSES)
@pytest.mark.parametrize("kind", ["padded", "packed"])
def test_analysis_leaves_training_as_a_clean_run(kind, attack):
    clean = _example(kind)
    clean["attack_args"] = {"enable_attack": False}
    _, clean_states, _, _ = _port_round_run(clean)
    _reset_singletons()
    config = _example(kind)
    config["attack_args"]["attack_type"] = attack
    sim, states, rows, att = _port_round_run(config)
    assert sim.analysis_attacked and not sim.secured and len(rows) == 2
    assert len(states) == len(clean_states) == 2
    for state, clean_state in zip(states, clean_states):
        for k in state:
            assert torch.equal(state[k], clean_state[k]), k
    result = att.last_revealed_labels if attack.startswith("revealing") else \
        att.last_reconstruction
    assert all(bool(torch.isfinite(t.float()).all()) for t in result)


# -- second derivatives through the flash kernels --------------------------------------


def test_second_derivative_through_flash_attention_raises():
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(1, 16, 2, 8).astype(np.float32)).requires_grad_()
               for _ in range(3))
    out = fa.flash_attention(q, k, v, True)
    (dq,) = torch.autograd.grad(out.square().sum(), q, retain_graph=True)  # first order
    assert dq.shape == q.shape and not dq.requires_grad
    with pytest.raises(RuntimeError, match="flash attention is once-differentiable"):
        torch.autograd.grad(out.square().sum(), q, create_graph=True)
    qp = torch.arange(16, dtype=torch.int32)
    m = torch.full((1, 2, 16), -float("inf"))
    l, o = torch.zeros(1, 2, 16), torch.zeros(1, 16, 2, 8)
    _, _, o2 = fa.flash_shard_update(q, k, v, qp, qp, m, l, o, True)
    with pytest.raises(RuntimeError, match="shard fold is once-differentiable"):
        torch.autograd.grad(o2.square().sum(), q, create_graph=True)
    # the attacks' gradient of a gradient through a model that attends raises too
    from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    lm = TransformerLM(TransformerConfig(vocab_size=16, d_model=16, n_heads=2, n_layers=1,
                                         d_ff=32), device="meta")
    lm.to_empty(device="cpu")
    variables = {n: torch.randn(p.shape, generator=torch.Generator().manual_seed(0))
                 for n, p in lm.named_parameters()}
    grad_fn = TA.victim_grad_fn(lm, variables)
    with pytest.raises(RuntimeError, match="flash attention is once-differentiable"):
        grad_fn(torch.randint(0, 16, (1, 8)), torch.full((1, 8, 16), 1.0 / 16))


# -- the centralized baseline --------------------------------------------------------


def test_centralized_trainer_matches_jax():
    from fedml_tpu.centralized import CentralizedTrainer as JCentralized
    from fedml_tpu_torch.centralized import CentralizedTrainer

    config = {"common_args": {"training_type": "simulation", "random_seed": 0},
              "data_args": {"dataset": "mnist", "synthetic_train_size": 200},
              "model_args": {"model": "lr"},
              "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 1,
                             "client_num_per_round": 1, "comm_round": 2, "epochs": 2,
                             "batch_size": 256, "client_optimizer": "sgd",
                             "learning_rate": 0.1},
              "device_args": {"device_type": "cpu"}}
    jargs = fedml_tpu.init(fedml_tpu.Arguments.from_dict(copy.deepcopy(config)),
                           should_init_logs=False)
    jct = JCentralized(jargs)
    targs = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)),
                                 should_init_logs=False)
    tct = CentralizedTrainer(targs)
    tct.variables = _port_tree(jct.variables, tct.module)
    jlast, tlast = jct.train(), tct.train()
    want = convert.params_state_from_flax(jax.tree_util.tree_map(np.asarray, jct.variables))
    assert sorted(want) == sorted(tct.variables)
    for k, v in tct.variables.items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=2e-5, err_msg=k)
    assert tlast["epoch"] == jlast["epoch"] == 3
    for key in ("test_acc", "test_loss"):
        assert abs(tlast[key] - jlast[key]) <= 2e-4, (tlast, jlast)
