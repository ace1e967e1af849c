"""The in-mesh FedGAN and FedNAS rounds of the port (``backend: XLA``)
against the JAX ``GANInMeshAPI`` and ``NASInMeshAPI`` on a one-device CPU
mesh, on the same data, from the same initial weights (flax's trees
transplanted, the alphas copied), the GAN on the JAX key chain's draws.

* ``GANInMeshAPI`` on mnist (3 clients of 20, 16 and 5 rows: the small one
  reads its padded index row, the window rule ``(i * bs) mod max(min(n,
  rows) - bs, 1)`` moves on the large one), 2 rounds: G and D (adam)
  within 2 lr a step and their updates within 0.15 of JAX's (relative
  norm), the health scores within 1e-3.
* ``NASInMeshAPI`` on cifar10 (4 clients of 16, 2 a round, 2 rounds): the
  weights within 5e-5 of JAX's, the alphas within 2 ``arch_learning_rate`` a
  step and their update within 1e-3 (relative norm), the genotype; and
  against the port's own ``sp`` FedNAS from the port's init: weights and
  alphas within 1e-5 (the same loop, the clients in slot order), the eval
  history equal.  With
  ``frequency_of_the_test: 0`` the in-mesh round runs without an eval, as
  its JAX twin does.
* ``SimulatorXLA`` routes ``fedgan`` and ``fednas`` to these rounds, which
  refuse the trust hooks; both ``xla_*`` example configs run as they stand.
"""

import numpy as np
import pytest
import torch

import fedml_tpu_torch
import test_torch_structural_sp as _st
from test_torch_structural_sp import CPU, GN_ATOL, both_args, load, max_diff, transplant


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_clean_singletons = _st._clean_singletons
_quick_jax = _st._quick_jax


def _mesh():
    import jax
    from fedml_tpu.parallel.mesh import create_fl_mesh

    return create_fl_mesh(devices=jax.devices()[:1])


def _replicated(japi, *names):
    """The JAX API's initial trees placed replicated on its mesh, as its
    round's outputs are (else round 1 compiles the program again)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    for name in names:
        setattr(japi, name, jax.device_put(getattr(japi, name),
                                           NamedSharding(japi.mesh, PartitionSpec())))


class JaxMeshLatents:
    """The JAX in-mesh FedGAN's draws, replayed: each round ``split`` of the
    run key, one key a slot from ``split(fold_in(sub, round), slots)``,
    ``split(rng, 3)`` a step; then ``split`` of the run key for the health
    draw."""

    def __init__(self, seed, latent, slots):
        import jax

        self.jax, self.latent, self.slots = jax, latent, slots
        self.rng = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
        self.round, self.keys = None, None

    def client(self, round_idx, slot, cid, steps, bs):
        jr = self.jax.random
        if self.round != round_idx:
            self.rng, sub = jr.split(self.rng)
            self.keys, self.round = jr.split(jr.fold_in(sub, round_idx), self.slots), round_idx
        rng, zs = self.keys[slot], []
        for _ in range(steps):
            rng, k1, k2 = jr.split(rng, 3)
            zs.append([jr.normal(k, (bs, self.latent)) for k in (k1, k2)])
        return torch.from_numpy(np.array(zs))

    def health(self, round_idx):
        self.rng, sub = self.jax.random.split(self.rng)
        return torch.from_numpy(np.array(self.jax.random.normal(sub, (64, self.latent))))


def test_gan_inmesh_matches_jax_on_its_draws():
    from fedml_tpu.simulation.xla.gan_nas import GANInMeshAPI as JGAN
    from fedml_tpu_torch.simulation.xla.gan_nas import GANInMeshAPI

    cfg = _st.gan_config("XLA")
    dataset = load(cfg, sizes=(20, 16, 5))
    jargs, targs = both_args(cfg)
    japi = JGAN(jargs, None, dataset, None, mesh=_mesh())
    _replicated(japi, "g_params", "d_params")
    api = GANInMeshAPI(targs, CPU, dataset, latents=JaxMeshLatents(0, 8, 3))
    assert api.padded_n == japi.padded_n == 24
    api.g_params = transplant(api.G, japi.g_params)
    api.d_params = transplant(api.D, japi.d_params)
    init = {"G": api.g_params, "D": api.d_params}
    history = []
    log = japi.metrics.log
    japi.metrics.log = lambda m, step=None: (history.append(dict(m)), log(m, step))
    japi.train()
    api.train()
    _st.gan_close(api, japi, 2, init)
    assert len(api.history) == len(history) == 2
    for h, jh in zip(api.history, history):
        assert abs(h["d_fake_score"] - jh["d_fake_score"]) <= 1e-3


def _port_nas(cls, cfg, dataset):
    args = fedml_tpu_torch.init(fedml_tpu_torch.Arguments.from_dict(cfg), should_init_logs=False)
    api = cls(args, CPU, dataset)
    return api, api.train()


def test_nas_inmesh_matches_jax_and_its_sp_twin():
    from fedml_tpu.simulation.xla.gan_nas import NASInMeshAPI as JNAS
    from fedml_tpu_torch.simulation.sp.fednas.fednas_api import FedNASAPI
    from fedml_tpu_torch.simulation.xla.gan_nas import NASInMeshAPI

    cfg = _st.nas_config("XLA")
    dataset = load(cfg)
    jargs, targs = both_args(cfg)
    japi = JNAS(jargs, None, dataset, None, mesh=_mesh())
    _replicated(japi, "params", "alphas")
    api = NASInMeshAPI(targs, CPU, dataset)
    api.params = transplant(api.net, japi.params)
    api.alphas = torch.from_numpy(np.array(japi.alphas))
    alphas0 = api.alphas
    want, got = japi.train(), api.train()
    assert max_diff(api.params, japi.params) <= GN_ATOL
    _st.nas_alphas_close(api, japi, cfg, alphas0)
    assert got["genotype"] == want["genotype"]
    # the port's in-mesh round against its sp twin, each from the port's init
    mesh, mesh_out = _port_nas(NASInMeshAPI, cfg, dataset)
    sp, sp_out = _port_nas(FedNASAPI, cfg, dataset)
    assert max(float((mesh.params[k] - sp.params[k]).abs().max()) for k in sp.params) <= 1e-5
    assert float((mesh.alphas - sp.alphas).abs().max()) <= 1e-5
    assert mesh.eval_history == sp.eval_history and mesh_out == sp_out


def test_nas_inmesh_skips_its_eval_at_frequency_zero():
    from fedml_tpu_torch.simulation.xla.gan_nas import NASInMeshAPI

    cfg = _st.nas_config("XLA")
    cfg["train_args"]["comm_round"] = 1
    cfg["validation_args"]["frequency_of_the_test"] = 0
    api, out = _port_nas(NASInMeshAPI, cfg, load(cfg))
    assert api.eval_history == [] and sorted(out) == ["genotype"]


@pytest.mark.parametrize("optimizer,cls", [("FedGAN", "GANInMeshAPI"),
                                           ("FedNAS", "NASInMeshAPI")])
def test_simulator_xla_routes_and_refuses_the_hooks(optimizer, cls):
    sim = _st._build(optimizer, backend="XLA")
    assert type(sim.sim).__name__ == cls
    for hook in ("model attack", "local DP"):
        with pytest.raises(NotImplementedError, match=f"{cls} does not run the .*{hook}"):
            _st._build(optimizer, backend="XLA", **_st._hooks.HOOK_KNOBS[hook])
        _st._sp._reset_singletons()


@pytest.mark.parametrize("name,cls", [("xla_fedgan_mnist_gan", "GANInMeshAPI"),
                                      ("xla_fednas_cifar10_darts", "NASInMeshAPI")])
def test_example_config_runs_on_the_port(name, cls):
    final, api = _st.run_example(name)
    assert type(api).__name__ == cls and final["round"] == 1 and len(api.round_times) == 2
    if cls == "GANInMeshAPI":
        assert 0.0 <= final["d_fake_score"] <= 1.0
        assert _st.finite(api.g_params) and _st.finite(api.d_params)
    else:
        assert len(final["genotype"]) == 4 and _st.finite(api.params)
