"""The port's differential privacy against the JAX package's.

* The Gaussian mechanism's sigma and the Laplace mechanism's scale, for a
  grid of (epsilon, delta, sensitivity), equal the JAX formulas.
* The noise: JAX's own draw, fed through the port's ``apply``, gives JAX's
  noised tree (each leaf's dtype kept, non-float leaves untouched); the
  port's Laplace inverse CDF on JAX's uniform draw gives
  ``jax.random.laplace`` (fp32, atol 1e-6).
* The budget accountant (a verbatim copy) spends, composes and exhausts as
  the JAX one does; the engine charges Laplace no delta and refuses bad
  configurations as JAX's does; its own draws replay from ``random_seed``.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.dp import budget_accountant as jbudget
from fedml_tpu.core.dp import mechanisms as jmech
from fedml_tpu.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy as JDP
from fedml_tpu_torch.core.dp import budget_accountant as tbudget
from fedml_tpu_torch.core.dp import mechanisms as tmech
from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy

GRID = [(0.5, 1e-5, 1.0), (2.0, 1e-3, 0.1), (8.0, 0.2, 3.0)]



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
    JDP._instance = FedMLDifferentialPrivacy._instance = None


@pytest.mark.parametrize("eps,delta,sens", GRID)
def test_sigma_and_scale_formulas(eps, delta, sens):
    g = tmech.create_mechanism("gaussian", eps, delta, sens)
    assert g.sigma == jmech.create_mechanism("gaussian", eps, delta, sens).sigma
    assert g.sigma == pytest.approx(math.sqrt(2 * math.log(1.25 / delta)) * sens / eps)
    lap = tmech.create_mechanism("laplace", eps, delta, sens)
    assert lap.scale == jmech.create_mechanism("laplace", eps, delta, sens).scale == sens / eps


def test_mechanisms_refuse_what_jax_refuses():
    for bad in (lambda m: m.Gaussian(1.0, 0.0), lambda m: m.Gaussian(0.0, 1e-5),
                lambda m: m.Laplace(-1.0), lambda m: m.create_mechanism("exp", 1.0, 1e-5, 1.0)):
        with pytest.raises(ValueError):
            bad(jmech)
        with pytest.raises(ValueError):
            bad(tmech)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"a": rng.normal(0, 1, (4, 3)).astype(np.float32),
            "b": rng.normal(0, 1, (5,)).astype(np.float32)}


@pytest.mark.parametrize("kind", ["gaussian", "laplace"])
def test_apply_takes_jax_draw(kind):
    mech_j = jmech.create_mechanism(kind, 1.5, 1e-5, 0.7)
    tree = _tree(0)
    key = jax.random.PRNGKey(11)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    want = mech_j.add_noise(jtree, key)
    noise = mech_j.add_noise({k: jnp.zeros_like(v) for k, v in jtree.items()}, key)
    got = tmech.apply({k: torch.from_numpy(v) for k, v in tree.items()},
                      {k: torch.from_numpy(np.array(v)) for k, v in noise.items()})
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6)


def test_laplace_inverse_cdf_is_jax_laplace():
    key = jax.random.PRNGKey(3)
    eps = float(jnp.finfo(jnp.float32).epsneg)
    u = jax.random.uniform(key, (2000,), jnp.float32, minval=-1.0 + eps, maxval=1.0)
    got = tmech.laplace_from_uniform(torch.from_numpy(np.array(u))).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.random.laplace(key, (2000,))), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["gaussian", "laplace"])
def test_noise_keeps_dtypes_and_skips_integers(kind):
    mech = tmech.create_mechanism(kind, 1.0, 1e-5, 1.0)
    tree = {"w": torch.zeros(64, dtype=torch.bfloat16), "n": torch.arange(3)}
    out = mech.add_noise(tree, torch.Generator().manual_seed(0))
    assert out["w"].dtype == torch.bfloat16 and float(out["w"].float().abs().max()) > 0
    assert out["n"] is tree["n"]


def test_accountant_spends_and_exhausts_as_jax():
    for mod in (jbudget, tbudget):
        acc = mod.BudgetAccountant(3.0, 1e-4)
        for _ in range(3):
            acc.spend(1.0, 2e-5)
        with pytest.raises(RuntimeError, match="privacy budget exhausted"):
            acc.spend(0.5, 0.0)
    j, t = jbudget.BudgetAccountant(10.0, 1.0), tbudget.BudgetAccountant(10.0, 1.0)
    for e in (0.1, 0.2, 0.3):
        j.spend(e, 1e-6)
        t.spend(e, 1e-6)
    assert t.total() == j.total() and t.total_advanced() == j.total_advanced()
    assert t.remaining == j.remaining and len(t) == len(j) == 3


def _args(**kw):
    base = dict(enable_dp=True, dp_type="cdp", mechanism_type="gaussian", epsilon=1.0,
                delta=1e-5, random_seed=3)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("kw,err", [({"dp_type": "xdp"}, ValueError),
                                    ({"privacy_budget": "lots"}, ValueError),
                                    ({"mechanism_type": "cauchy"}, ValueError)])
def test_engine_refuses_bad_configs_as_jax(kw, err):
    for cls in (JDP, FedMLDifferentialPrivacy):
        with pytest.raises(err):
            cls().init(_args(**kw))


@pytest.mark.parametrize("mechanism,delta_charged", [("gaussian", 1e-5), ("laplace", 0.0)])
def test_engine_spends_as_jax(mechanism, delta_charged):
    args = _args(mechanism_type=mechanism, privacy_budget=[3.0, 1.0])
    jdp, tdp = JDP(), FedMLDifferentialPrivacy()
    jdp.init(args)
    tdp.init(args)
    assert tdp.noise_scale() == jdp.noise_scale()
    tdp.spend_budget(2)
    jdp.spend_budget(2)
    assert tdp.accountant.total() == jdp.accountant.total() == (2.0, 2 * delta_charged)
    tdp.add_global_noise({"w": torch.zeros(8)})
    assert tdp.accountant.total() == pytest.approx((3.0, 3 * delta_charged))
    with pytest.raises(RuntimeError, match="privacy budget exhausted"):
        tdp.add_local_noise({"w": torch.zeros(8)})


def test_engine_draws_replay_from_the_seed():
    outs = []
    for _ in range(2):
        dp = FedMLDifferentialPrivacy()
        dp.init(_args())
        outs.append([dp.add_noise({"w": torch.zeros(16)})["w"] for _ in range(2)])
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][0], outs[0][1])  # drawn in turn
    dp = FedMLDifferentialPrivacy()
    dp.init(_args(random_seed=4))
    assert not torch.equal(dp.add_noise({"w": torch.zeros(16)})["w"], outs[0][0])
