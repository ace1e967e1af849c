"""FedGAN of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/fedgan/fedgan_api.py``, ``FedGanAPI``): federated
generative adversarial training.

The generator (``MNISTGenerator`` at ``gan_latent_dim``) and the
discriminator (``MNISTDiscriminator``) are built here; the hub's model is
not read, as in the JAX twin.  Each round every sampled client with data
trains its own copy of both from the global pair (``local_gan``):
``gan_local_steps`` alternating steps, each a D step on BCE(D(real), 1) +
BCE(D(G(z1)), 0), then a G step on BCE(D(G(z2)), 1) against the stepped D,
each with a fresh adam (lr ``learning_rate``, b1 0.5; ``client_optimizer``
is not read).  Step i's real batch is the window of ``batch_size`` rows at
``(i * batch_size) mod max(len - batch_size, 1)``.  A client's images are
tiled to one batch when it has fewer, gain a channel axis and are mapped to
tanh's range (x * 2 - 1).  The server takes the mean of both nets weighted
by each client's (tiled) row count, then scores the pair's health: the mean
of sigmoid(D(G(z))) over 64 draws, ``d_fake_score``, rounded to 4 decimals.
``frequency_of_the_test`` is not read, as in the JAX twin.

Latent draws.  ``jax.random`` cannot be reproduced in torch, so the draws
come from a latent source (``GanLatents`` by default: CPU generators seeded
per (round, client) and per round, ``utils/rng.py``, so the card and the CPU
draw the same numbers).  A source with the same two methods can be passed
in; the parity tests pass one that replays the JAX key chain.  No trust hook
runs: each is refused when the object is built (the table is in
``simulation/sp/__init__.py``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ....core.aggregate import weighted_mean
from ....core.sampling import client_sampling
from ....device import fp32_matmul
from ....ml.engine.train import get_variables, init_variables, load_variables
from ....ml.trainer.cls_trainer import to_device
from ....models.gan import MNISTDiscriminator, MNISTGenerator
from ....utils.metrics import MetricsLogger
from ....utils.rng import GAN_HEALTH_SALT, GAN_LATENT_SALT, seeded_generator
from ...xla.fed_sim import XLA_ROUND_KNOBS
from ..fedavg.fedavg_api import own_loop_setup

logger = logging.getLogger(__name__)

HEALTH_DRAWS = 64
ADAM_BETAS = (0.5, 0.999)


class GanLatents:
    """The default latent source: a client run's draws from the CPU
    generator of (seed, 6011, round, client), a round's health draw from
    that of (seed, 6013, round)."""

    def __init__(self, seed: int, latent: int):
        self.seed, self.latent = int(seed), int(latent)

    def client(self, round_idx: int, slot: int, cid: int, steps: int, bs: int) -> torch.Tensor:
        """[steps, 2, bs, latent]: each step's D draw, then its G draw.
        ``slot`` is the client's place in the round's order (unused here)."""
        gen = seeded_generator((self.seed, GAN_LATENT_SALT, round_idx, cid))
        return torch.randn((steps, 2, bs, self.latent), generator=gen)

    def health(self, round_idx: int) -> torch.Tensor:
        """[64, latent]: the round's health draw."""
        gen = seeded_generator((self.seed, GAN_HEALTH_SALT, round_idx))
        return torch.randn((HEALTH_DRAWS, self.latent), generator=gen)


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


def local_gan(G: MNISTGenerator, D: MNISTDiscriminator, g_vars, d_vars, x: torch.Tensor,
              z: torch.Tensor, starts: Sequence[int], lr: float):
    """One client's alternating D/G steps from (``g_vars``, ``d_vars``) on
    its rows ``x`` (tanh range, NHWC): step i takes the real window at
    ``starts[i]`` and the latents ``z[i]`` ([2, bs, latent]), fresh adams
    with b1 0.5.  Returns the client's (G, D) variables and the sum of its
    steps' D and G losses (a [2] tensor on the device)."""
    load_variables(G, g_vars)
    load_variables(D, d_vars)
    G.train()
    D.train()
    g_params, d_params = list(G.parameters()), list(D.parameters())
    g_opt = torch.optim.Adam(g_params, lr=lr, betas=ADAM_BETAS)
    d_opt = torch.optim.Adam(d_params, lr=lr, betas=ADAM_BETAS)
    bs = z.shape[2]
    losses = torch.zeros(2, device=x.device)
    for i, start in enumerate(starts):
        real = x[start:start + bs]
        with torch.no_grad():
            fake = G(z[i, 0])
        d_loss = _bce(D(real), 1.0) + _bce(D(fake), 0.0)
        d_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        d_opt.step()
        g_loss = _bce(D(G(z[i, 1])), 1.0)
        g_opt.zero_grad(set_to_none=True)
        g_loss.backward(inputs=g_params)
        g_opt.step()
        losses += torch.stack([d_loss.detach(), g_loss.detach()])
    return get_variables(G), get_variables(D), losses


@torch.no_grad()
def d_fake_score(G: MNISTGenerator, D: MNISTDiscriminator, g_vars, d_vars,
                 z: torch.Tensor) -> float:
    """Mean sigmoid(D(G(z))): the discriminator's realism score of fakes."""
    load_variables(G, g_vars)
    load_variables(D, d_vars)
    return float(torch.sigmoid(D(G(z))).mean())


def build_pair(args, device: torch.device):
    """(G, D, G's variables, D's variables, latent width) from
    ``gan_latent_dim`` and ``random_seed``."""
    latent = int(getattr(args, "gan_latent_dim", 100))
    seed = int(getattr(args, "random_seed", 0))
    G, D = MNISTGenerator(latent, device="meta"), MNISTDiscriminator(device="meta")
    g_vars = init_variables(G, device, seed=seed)
    d_vars = init_variables(D, device, seed=seed + 1)
    return G, D, g_vars, d_vars, latent


class FedGanAPI:
    _skip_knobs = XLA_ROUND_KNOBS  # the unported knobs not refused

    def __init__(self, args, device, dataset, model=None, latents=None):
        self.args = args
        own_loop_setup(args, type(self).__name__, frequency=False, skip=self._skip_knobs)
        self.device = torch.device(device)
        (_, _, _tg, _teg, self.local_num, self.local_train, _lt, _cn) = dataset
        self.G, self.D, self.g_params, self.d_params, self.latent = build_pair(args, self.device)
        self.lr = float(getattr(args, "learning_rate", 2e-4))
        self.bs = int(getattr(args, "batch_size", 32))
        self.latents = latents or GanLatents(int(getattr(args, "random_seed", 0)), self.latent)
        self.metrics = MetricsLogger(args)
        self.round_times: List[float] = []
        self.history: List[Dict[str, Any]] = []
        self.round_losses: List[Tuple[float, float]] = []  # mean D and G loss a step
        self._data: Dict[int, Any] = {}

    def _client(self, cid: int):
        """The client's rows on the device: tiled to one batch when fewer,
        a channel axis, tanh's range; None when it has none."""
        if cid not in self._data:
            x = np.asarray(self.local_train[cid][0], np.float32)
            if len(x) == 0:
                self._data[cid] = None
            else:
                if len(x) < self.bs:  # tile small clients up to one full batch
                    x = np.tile(x, (-(-self.bs // len(x)),) + (1,) * (x.ndim - 1))[:self.bs]
                x = to_device(x, self.device)
                if x.dim() == 3:
                    x = x[..., None]
                self._data[cid] = x * 2.0 - 1.0
        return self._data[cid]

    def train(self) -> Dict[str, Any]:
        with fp32_matmul():
            return self._train()

    def _round_clients(self, round_idx: int) -> Iterator[Tuple[int, int, torch.Tensor, int, float]]:
        """(slot, client, rows, window span, weight) of each client that
        trains in the round: the sampled clients with data, in sampled
        order, each weighted by its (tiled) row count; step i's window
        starts at ``(i * batch_size) mod span``."""
        sampled = client_sampling(round_idx, int(self.args.client_num_in_total),
                                  int(self.args.client_num_per_round))
        for slot, cid in enumerate(int(c) for c in sampled):
            x = self._client(cid)
            if x is not None:
                yield slot, cid, x, max(len(x) - self.bs, 1), float(len(x))

    def _train(self) -> Dict[str, Any]:
        rounds = int(self.args.comm_round)
        steps = int(getattr(self.args, "gan_local_steps", 20))
        bs = self.bs
        last: Dict[str, Any] = {}
        for r in range(rounds):
            t0 = time.time()
            g_locals: List[Tuple[float, Any]] = []
            d_locals: List[Tuple[float, Any]] = []
            loss_sum = torch.zeros(2, device=self.device)
            for slot, cid, x, span, weight in self._round_clients(r):
                z = self.latents.client(r, slot, cid, steps, bs).to(self.device)
                gp, dp, losses = local_gan(self.G, self.D, self.g_params, self.d_params, x, z,
                                           [(i * bs) % span for i in range(steps)], self.lr)
                g_locals.append((weight, gp))
                d_locals.append((weight, dp))
                loss_sum += losses
            self.g_params = weighted_mean(g_locals)
            self.d_params = weighted_mean(d_locals)
            d_mean, g_mean = (loss_sum / max(len(g_locals) * steps, 1)).tolist()
            self.round_losses.append((d_mean, g_mean))
            score = d_fake_score(self.G, self.D, self.g_params, self.d_params,
                                 self.latents.health(r).to(self.device))
            self.round_times.append(time.time() - t0)
            last = {"round": r, "d_fake_score": round(score, 4)}
            self.history.append(last)
            self.metrics.log(last)
        return last
