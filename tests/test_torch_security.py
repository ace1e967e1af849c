"""The port's security math against the JAX package's, and against itself.

* The flat layout: a variables dict of the ``lr`` model, ResNet-20 and a
  small TransformerLM, raveled by ``FlatLayout``, is ``ravel_pytree`` of the
  transplanted flax tree, element for element, and unravels back bit for bit.
* Every stacked defense in tree mode and in rows mode, and every stacked
  attack, against the JAX package's stacked form on the same inputs: six
  updates of a two-layer tree (39 coordinates, two dense kernels stored
  transposed in the port), one outlier far from the rest.  The random rules
  (byzantine ``random``, weak_dp, wbc) take JAX's own draw.  fp32, atol 1e-6
  with rtol 1e-6 (values up to about 8; fp32 spacing there is 9.5e-7).
* The host dispatcher (``FedMLAttacker.attack_model``, ``FedMLDefender``'s
  three hooks, over lists) against the stacked form, and against the JAX
  package's host dispatcher (``tests/test_stacked_security.py``'s matrix).
* The even-n median, the data attacks with JAX's choices, the soteria probe's
  Jacobian scores, the attacker's malicious set and the server aggregator's
  hook order.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from fedml_tpu.core.aggregate import weighted_mean as jweighted_mean
from fedml_tpu.core.security import attack_funcs as JA
from fedml_tpu.core.security import defense_funcs as JF
from fedml_tpu.core.security import stacked as JS
from fedml_tpu.core.security.fedml_attacker import FedMLAttacker as JAttacker
from fedml_tpu.core.security.fedml_defender import FedMLDefender as JDefender
from fedml_tpu_torch.core.security import attack_funcs as TA
from fedml_tpu_torch.core.security import defense_funcs as TF
from fedml_tpu_torch.core.security import stacked as TS
from fedml_tpu_torch.core.security.fedml_attacker import FedMLAttacker
from fedml_tpu_torch.core.security.fedml_defender import SUPPORTED_DEFENSES, FedMLDefender
from fedml_tpu_torch.models import convert

RTOL = ATOL = 1e-6
N = 6
D = 39


class _Args:
    def __init__(self, **kw):
        self.random_seed = 0
        for k, v in kw.items():
            setattr(self, k, v)



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
    JAttacker._attacker_instance = JDefender._defender_instance = None
    FedMLAttacker._attacker_instance = FedMLDefender._defender_instance = None


def _vec_to_trees(v):
    """A 39-vector as (the JAX tree, the port's dict) of the same model:
    fc1 5 -> 4, fc2 4 -> 3, kernels [in, out] in flax, weights [out, in]."""
    v = np.asarray(v, np.float32)
    k1, b1, k2, b2 = v[:20].reshape(5, 4), v[20:24], v[24:36].reshape(4, 3), v[36:39]
    # flax order: fc1/bias, fc1/kernel, fc2/bias, fc2/kernel
    jtree = {"params": {"fc1": {"kernel": jnp.asarray(k1), "bias": jnp.asarray(b1)},
                        "fc2": {"kernel": jnp.asarray(k2), "bias": jnp.asarray(b2)}}}
    ttree = {"fc1.weight": torch.from_numpy(k1.T.copy()), "fc1.bias": torch.from_numpy(b1.copy()),
             "fc2.weight": torch.from_numpy(k2.T.copy()), "fc2.bias": torch.from_numpy(b2.copy())}
    return jtree, ttree


def _updates(n=N, seed=0, outlier=(2,)):
    rng = np.random.RandomState(seed)
    jups, tups = [], []
    for i in range(n):
        vec = rng.normal(8.0, 0.5, D) if i in outlier else rng.normal(1.0, 0.05, D)
        j, t = _vec_to_trees(vec)
        jups.append((float(1 + i % 3), j))
        tups.append((float(1 + i % 3), t))
    return jups, tups


JGLOBAL, TGLOBAL = _vec_to_trees(np.ones(D))


def _jstack(updates):
    stack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, 0), *[p for _, p in updates])
    return stack, jnp.asarray([n for n, _ in updates], jnp.float32)


def _tstack(updates):
    stack = {k: torch.stack([p[k] for _, p in updates], 0) for k in updates[0][1]}
    return stack, torch.tensor([n for n, _ in updates], dtype=torch.float32)


def _jflat(tree):
    return np.asarray(ravel_pytree(tree)[0])


def _tflat(tree):
    return convert.FlatLayout.of(tree).ravel(tree).numpy()


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


# -- the flat layout ---------------------------------------------------------

def _flax_and_port(model):
    """A flax tree of the model's structure (its init traced, not run; seeded
    values) and the port's variables transplanted from it."""
    import fedml_tpu.models.hub as jhub
    from fedml_tpu_torch.models import hub

    if model == "transformer":
        from fedml_tpu.models.transformer import TransformerConfig as JCfg
        from fedml_tpu.models.transformer import TransformerLM as JLM
        from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM

        kw = dict(vocab_size=40, d_model=32, n_heads=2, n_layers=2, d_ff=48)
        jm, x = JLM(JCfg(**kw)), jnp.zeros((1, 8), jnp.int32)
        tm = TransformerLM(TransformerConfig(**kw), device="meta")
    else:
        a = types.SimpleNamespace(model=model, dataset="mnist" if model == "lr" else "cifar10")
        jm = jhub.create(a, 10)
        x = jnp.zeros((1, 28, 28, 1) if model == "lr" else (1, 32, 32, 3))
        tm = hub.create(a, 10)
    rng = np.random.RandomState(0)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    jv = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    return jv, convert.variables_from_flax(jv, tm, torch.device("cpu"))


@pytest.mark.parametrize("model", ["lr", "resnet20", "transformer"])
def test_flat_layout_is_ravel_pytree_order(model):
    jv, tv = _flax_and_port(model)
    layout = convert.FlatLayout.of(tv)
    want = np.asarray(ravel_pytree(jv)[0])
    got = layout.ravel(tv).numpy()
    assert got.shape == want.shape == (layout.dim,)
    np.testing.assert_array_equal(got, want)
    back = layout.unravel(layout.ravel(tv), tv)
    for k, v in tv.items():
        assert torch.equal(back[k], v) and back[k].stride() == v.stride(), k
    # a stack of two rows: each row is its tree's ravel
    stack = {k: torch.stack([v, 2 * v]) for k, v in tv.items()}
    mat = TS.stack_to_mat(stack)
    np.testing.assert_array_equal(mat[1].numpy(), 2 * want)


# -- stacked defenses against JAX's --------------------------------------------

DEFENSE_CASES = [
    ("krum", dict(byzantine_client_num=1)),
    ("multi_krum", dict(byzantine_client_num=1, krum_param_m=3)),
    ("norm_diff_clipping", dict(norm_bound=2.0)),
    ("3sigma", {}),
    ("geometric_median", dict(geo_median_max_iter=8)),
    ("rfa", dict(geo_median_max_iter=8)),
    ("cclip", dict(tau=1.5, bucket_iter=2)),
    ("slsgd", dict(trim_param_b=1, alpha=0.5)),
    ("foolsgold", {}),
    ("robust_learning_rate", dict(robust_threshold=4)),
    ("coordinate_wise_median", {}),
    ("coordinate_wise_trimmed_mean", dict(beta=0.2)),
    ("bulyan", dict(byzantine_client_num=1)),
    ("weak_dp", dict(stddev=0.5)),
    ("wbc", dict(wbc_strength=0.5, wbc_lr=0.5, client_num_in_total=6, client_num_per_round=6)),
    ("soteria", dict(soteria_layer=("fc2", "kernel"), soteria_percentile=34.0)),
]


def test_defense_matrix_is_complete():
    assert sorted({name for name, _ in DEFENSE_CASES}) == SUPPORTED_DEFENSES


def _jax_draw(defense, key):
    if defense == "weak_dp":
        return jax.random.normal(key, (D,))
    if defense == "wbc":
        return jax.random.uniform(key, (N, D), minval=-0.5 + 1e-7, maxval=0.5)
    return None


def _both_defenses(defense, extra, rows):
    """Two calls (state carried) of the JAX and the port stacked defense on
    the same updates and draws; returns the four outputs."""
    jups, tups = _updates()
    jstack, jw = _jstack(jups)
    tstack, tw = _tstack(tups)
    jfn = JS.build_stacked_defense(_Args(**extra), defense, rows=rows)
    tfn = TS.build_stacked_defense(_Args(**extra), defense, rows=rows)
    jstate = JS.init_defense_state(defense, N, D)
    tstate = TS.init_defense_state(defense, N, D)
    outs = []
    for call in range(2):
        key = jax.random.PRNGKey(call)
        draw = _jax_draw(defense, key)
        jout = jfn(jstack, jw, JGLOBAL, key, jstate)
        tout = tfn(tstack, tw, TGLOBAL, None, tstate,
                   noise=None if draw is None else torch.from_numpy(np.array(draw)))
        jstate, tstate = jout[-1], tout[-1]
        outs.append((jout, tout))
    return outs


@pytest.mark.parametrize("defense,extra", DEFENSE_CASES)
def test_stacked_defense_tree_mode_matches_jax(defense, extra):
    for call, (jout, tout) in enumerate(_both_defenses(defense, extra, rows=False)):
        _close(_tflat(tout[0]), _jflat(jout[0]), f"{defense} call {call}")
        for k in jout[1]:
            _close(tout[1][k].numpy(), jout[1][k], f"{defense} state {k}")


@pytest.mark.parametrize("defense,extra", DEFENSE_CASES)
def test_stacked_defense_rows_mode_matches_jax(defense, extra):
    for call, (jout, tout) in enumerate(_both_defenses(defense, extra, rows=True)):
        _close(tout[0].numpy(), jout[0], f"{defense} rows, call {call}")
        _close(tout[1].numpy(), jout[1], f"{defense} weights, call {call}")
    # the rows' weighted mean is the tree-mode aggregate, in the port too
    jups, tups = _updates()
    tstack, tw = _tstack(tups)
    state = TS.init_defense_state(defense, N, D)
    draw = _jax_draw(defense, jax.random.PRNGKey(0))
    noise = None if draw is None else torch.from_numpy(np.array(draw))
    agg, _ = TS.build_stacked_defense(_Args(**extra), defense)(tstack, tw, TGLOBAL, None, state,
                                                               noise=noise)
    mat2, w2, _ = TS.build_stacked_defense(_Args(**extra), defense, rows=True)(
        tstack, tw, TGLOBAL, None, state, noise=noise)
    _close(((w2 @ mat2) / w2.sum().clamp_min(1e-9)).numpy(), _tflat(agg), defense)


# -- stacked attacks against JAX's ----------------------------------------------

ATTACK_CASES = [
    ("byzantine", dict(attack_mode="zero", byzantine_client_num=2)),
    ("byzantine", dict(attack_mode="random", byzantine_client_num=2)),
    ("byzantine", dict(attack_mode="flip", byzantine_client_num=2)),
    ("model_replacement", dict(attack_scale=5.0, byzantine_client_num=2)),
    ("backdoor", dict(attack_mode="craft", attack_num_std=1.5, byzantine_client_num=2)),
    ("backdoor", dict(attack_mode="clip", attack_num_std=1.5, byzantine_client_num=2)),
    ("backdoor", dict(attack_num_std=1.5, byzantine_client_num=2)),  # ALIE's default: craft
    ("edge_case_backdoor", dict(attack_scale=5.0, attack_norm_bound=2.0,
                                byzantine_client_num=2)),
]


@pytest.mark.parametrize("attack,extra", ATTACK_CASES)
def test_stacked_attack_matches_jax(attack, extra):
    jups, tups = _updates(outlier=())
    jstack, jw = _jstack(jups)
    tstack, tw = _tstack(tups)
    jmat, tmat = JS.stack_to_mat(jstack), TS.stack_to_mat(tstack)
    mal = np.zeros(N, np.float32)
    mal[[1, 4]] = 1.0
    key = jax.random.PRNGKey(3)
    jout = JS.build_stacked_attack(_Args(**extra), attack)(
        jmat, jw, jnp.asarray(_jflat(JGLOBAL)), jnp.asarray(mal), key)
    tfn = TS.build_stacked_attack(_Args(**extra), attack)
    noise = None
    if tfn.random:
        noise = torch.from_numpy(np.array(jax.random.normal(key, jmat.shape, jmat.dtype)))
    tout = tfn(tmat, tw, torch.from_numpy(_tflat(TGLOBAL)), torch.from_numpy(mal), noise=noise)
    _close(tout.numpy(), jout, attack)
    benign = [0, 2, 3, 5]
    np.testing.assert_array_equal(tout.numpy()[benign], tmat.numpy()[benign])


def test_attack_mode_defaults_differ_by_attack():
    assert TS.build_stacked_attack(_Args(), "byzantine").mode == "random"
    assert TS.build_stacked_attack(_Args(), "backdoor").alie_mode == "craft"


# -- the host dispatcher against the stacked form and against JAX's -------------

def _host_defense_agg(defender, updates, global_params, mean):
    """The ServerAggregator hook order on the list path."""
    if defender.is_defense_before_aggregation():
        return mean(defender.defend_before_aggregation(updates, global_params))
    if defender.is_defense_on_aggregation():
        return defender.defend_on_aggregation(updates, lambda a, u: mean(u), global_params)
    return defender.defend_after_aggregation(mean(updates))


HOST_CASES = [(name, dict(extra, stddev=0.0) if name == "weak_dp" else
               dict(extra, wbc_strength=0.0) if name == "wbc" else extra)
              for name, extra in DEFENSE_CASES]  # the host draws stay out: deterministic


@pytest.mark.parametrize("defense,extra", HOST_CASES)
def test_host_dispatcher_matches_stacked_and_jax(defense, extra):
    jups, tups = _updates()
    td = FedMLDefender.get_instance()
    td.init(_Args(enable_defense=True, defense_type=defense, **extra))
    host = _host_defense_agg(td, tups, TGLOBAL, TF.weighted_mean)
    jd = JDefender.get_instance()
    jd.init(_Args(enable_defense=True, defense_type=defense, **extra))
    jhost = _host_defense_agg(jd, jups, JGLOBAL, jweighted_mean)
    _close(_tflat(host), _jflat(jhost), f"{defense}: port host vs JAX host")

    tstack, tw = _tstack(tups)
    state = TS.init_defense_state(defense, N, D)
    agg, _ = TS.build_stacked_defense(_Args(**extra), defense)(
        tstack, tw, TGLOBAL, torch.Generator().manual_seed(0), state)
    np.testing.assert_allclose(_tflat(agg), _tflat(host), rtol=2e-6, atol=2e-6,
                               err_msg=f"{defense}: stacked vs host")


HOST_ATTACKS = [c for c in ATTACK_CASES if c[1].get("attack_mode") != "random"]


@pytest.mark.parametrize("attack,extra", HOST_ATTACKS)
def test_attacker_host_dispatcher_matches_stacked_and_jax(attack, extra):
    jups, tups = _updates(outlier=())
    ta = FedMLAttacker.get_instance()
    ta.init(_Args(enable_attack=True, attack_type=attack, client_num_in_total=N, **extra))
    idxs = ta.get_byzantine_idxs(N)
    host = np.stack([_tflat(p) for _, p in ta.attack_model(list(tups), TGLOBAL)])
    ja = JAttacker.get_instance()
    ja.init(_Args(enable_attack=True, attack_type=attack, client_num_in_total=N, **extra))
    assert ja.get_byzantine_idxs(N) == idxs
    jhost = np.stack([_jflat(p) for _, p in ja.attack_model(list(jups), JGLOBAL)])
    _close(host, jhost, f"{attack}: port host vs JAX host")

    tstack, tw = _tstack(tups)
    mal = torch.zeros(N)
    mal[idxs] = 1.0
    stacked = TS.build_stacked_attack(_Args(**extra), attack)(
        TS.stack_to_mat(tstack), tw, torch.from_numpy(_tflat(TGLOBAL)), mal)
    _close(stacked.numpy(), host, f"{attack}: stacked vs host")


def test_byzantine_random_host_takes_its_draw():
    _, tups = _updates(outlier=())
    noise = [{k: torch.full_like(v, 3.0) for k, v in tups[0][1].items()}] * 2
    out = TA.byzantine_attack(tups, TGLOBAL, [1, 4], "random", noise=noise)
    assert all(torch.equal(out[i][1][k], noise[0][k]) for i in (1, 4) for k in noise[0])
    assert out[0][1] is tups[0][1]


@pytest.mark.parametrize("layer", [("fc2", "kernel"), "fc2/kernel", "fc2.weight", ("fc1", "bias")])
def test_soteria_stacked_matches_jax(layer):
    jups, tups = _updates()
    jstack, _ = _jstack(jups)
    tstack, _ = _tstack(tups)
    path = layer.replace(".weight", "/kernel").split("/") if isinstance(layer, str) else layer
    want = JS.stack_to_mat(JS._soteria_stacked(jstack, JGLOBAL, list(path), 34.0, None))
    _close(TS._soteria_stacked(tstack, TGLOBAL, layer, 34.0, None).numpy(), want, str(layer))


def test_foolsgold_history_accumulates_and_wbc_waits_a_round():
    _, tups = _updates()
    tstack, tw = _tstack(tups)
    fn = TS.build_stacked_defense(_Args(), "foolsgold")
    state = TS.init_defense_state("foolsgold", N, D)
    _, s1 = fn(tstack, tw, TGLOBAL, None, state)
    _, s2 = fn(tstack, tw, TGLOBAL, None, s1)
    assert float(s2["fg_hist"].abs().sum()) > float(s1["fg_hist"].abs().sum())
    fn = TS.build_stacked_defense(_Args(wbc_strength=5.0, wbc_lr=0.5), "wbc")
    state = TS.init_defense_state("wbc", N, D)
    gen = torch.Generator().manual_seed(0)
    a1, s1 = fn(tstack, tw, TGLOBAL, gen, state)
    assert float(s1["wbc_has"]) == 1.0
    _close(_tflat(a1), _tflat(TF.weighted_mean(tups)))  # no previous rows: no noise
    a2, _ = fn(tstack, tw, TGLOBAL, gen, s1)
    assert np.abs(_tflat(a2) - _tflat(a1)).max() > 0


# -- the even-n median ----------------------------------------------------------

@pytest.mark.parametrize("n", [4, 5, 6, 7])
def test_median_rows_is_jnp_median(n):
    x = np.random.RandomState(n).normal(0, 1, (n, 33)).astype(np.float32)
    got = TF.median_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.median(jnp.asarray(x), axis=0)))
    lower = torch.median(torch.from_numpy(x), dim=0).values.numpy()
    assert (n % 2 == 1) == bool(np.array_equal(got, lower))


# -- data attacks with JAX's choices ---------------------------------------------

def test_data_attacks_match_jax_given_its_choices():
    rng = np.random.RandomState(7)
    x = rng.rand(20, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 10, 20).astype(np.int32)
    np.testing.assert_array_equal(TA.flip_labels(torch.from_numpy(y), 1, 7).numpy(),
                                  np.asarray(JA.flip_labels(jnp.asarray(y), 1, 7)))
    key = jax.random.PRNGKey(5)
    jx, jy = JA.poison_backdoor(jnp.asarray(x), jnp.asarray(y), 3, 0.3, key)
    idx = jax.random.permutation(key, 20)[:6]  # the JAX choice
    tx, ty = TA.poison_backdoor(torch.from_numpy(x), torch.from_numpy(y), 3, 0.3,
                                idx=torch.from_numpy(np.array(idx)))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    gx, gy = TA.poison_backdoor(torch.from_numpy(x), torch.from_numpy(y), 3, 0.3,
                                gen=torch.Generator().manual_seed(0))
    assert int((gy.numpy() != y).sum()) <= 6 and int((gx.numpy() != x).any(axis=(1, 2, 3)).sum()) == 6
    logits = rng.normal(0, 2, (20, 10)).astype(np.float32)
    ex, ey = TA.poison_edge_cases(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(logits), 9, 0.25)
    jex, jey = JA.poison_edge_cases(jnp.asarray(x), jnp.asarray(y), jnp.asarray(logits), 9, 0.25)
    np.testing.assert_array_equal(ey.numpy(), np.asarray(jey))
    pool = rng.rand(5, 8, 8, 3).astype(np.float32)
    src, pos = np.array([4, 0, 4]), np.array([2, 11, 7])
    px, py = TA.inject_edge_cases(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(pool),
                                  9, torch.from_numpy(src), torch.from_numpy(pos))
    want_x = x.copy()
    want_x[pos] = pool[src]
    np.testing.assert_array_equal(px.numpy(), want_x)
    assert (py.numpy()[pos] == 9).all()


def test_attacker_malicious_set_and_label_flip_match_jax():
    args = _Args(enable_attack=True, attack_type="label_flipping", byzantine_client_num=3,
                 client_num_in_total=10, original_class=1, target_class=7, random_seed=4)
    ta, ja = FedMLAttacker.get_instance(), JAttacker.get_instance()
    ta.init(args)
    ja.init(args)
    assert ta.get_byzantine_idxs(10) == ja.get_byzantine_idxs(10)
    ta.set_round_clients([9, 2, 5, 7])
    ja.set_round_clients([9, 2, 5, 7])
    assert ta._malicious_slots(4) == ja._malicious_slots(4)
    y = np.arange(12) % 3
    x = np.zeros((12, 2), np.float32)
    for c in range(10):
        tx, ty = ta.poison_local_data(c, 10, x, y)
        jx, jy = ja.poison_local_data(c, 10, x, y)
        np.testing.assert_array_equal(np.asarray(ty), np.asarray(jy))


def test_analysis_attacks_are_refused():
    ta = FedMLAttacker.get_instance()
    ta.init(_Args(enable_attack=True, attack_type="dlg"))
    assert ta.is_analysis_attack()
    with pytest.raises(NotImplementedError, match="queue A, item 8: the trust path, what is left"):
        ta.analyze_update(None, None, None, (1,), 10)
    with pytest.raises(NotImplementedError, match="queue A, item 8: the trust path, what is left"):
        ta.reconstruct_data(None, None, None, (1,), 10)


# -- soteria's probe ---------------------------------------------------------------

def test_soteria_probe_scores_match_jax():
    rng = np.random.RandomState(2)
    w = rng.normal(0, 0.5, (6, 4)).astype(np.float32)
    xs = rng.normal(0, 1, (5, 6)).astype(np.float32)

    def jfeat(x):
        return jnp.tanh(x @ jnp.asarray(w)) + 0.1

    def tfeat(x):
        return torch.tanh(x @ torch.from_numpy(w)) + 0.1

    want = np.array(JF.soteria_scores(jfeat, jnp.asarray(xs)))
    got = TF.soteria_scores(tfeat, torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(TF.soteria_mask(torch.from_numpy(want), 40.0).numpy(),
                                  np.asarray(JF.soteria_mask(jnp.asarray(want), 40.0)))


# -- the server aggregator's hook order ---------------------------------------------

def test_server_aggregator_hooks_run_attacker_defender_then_dp():
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
    from fedml_tpu_torch.ml.aggregator.default_aggregator import DefaultServerAggregator

    _, tups = _updates()
    args = _Args(enable_attack=True, attack_type="byzantine", attack_mode="flip",
                 byzantine_client_num=2, client_num_in_total=N, enable_defense=True,
                 defense_type="coordinate_wise_median", enable_dp=True, dp_type="cdp",
                 mechanism_type="gaussian", epsilon=1e12)
    FedMLAttacker.get_instance().init(args)
    FedMLDefender.get_instance().init(args)
    FedMLDifferentialPrivacy._instance = None
    FedMLDifferentialPrivacy.get_instance().init(args)
    try:
        agg = DefaultServerAggregator(torch.nn.Linear(1, 1), args)
        agg.set_model_params(TGLOBAL)
        updates = agg.on_before_aggregation(list(tups))
        out = agg.on_after_aggregation(agg.aggregate(updates))
        attacked = FedMLAttacker.get_instance().attack_model(list(tups), TGLOBAL)
        want = TF.coordinate_wise_median(attacked)
        _close(_tflat(out), _tflat(want))
        assert len(FedMLDifferentialPrivacy.get_instance().accountant) == 1
    finally:
        FedMLDifferentialPrivacy._instance = None
