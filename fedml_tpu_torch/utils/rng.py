"""Seeded ``torch.Generator``s of the port.

The JAX package threads ``jax.random`` keys, which torch cannot reproduce.
The port draws from explicit generators instead, each seeded from a tuple of
ints through numpy's ``SeedSequence``.  The streams and their tuples (``s``
is ``random_seed``; the salts are the JAX package's key offsets):

======================================  ===================================
stream                                  seed tuple
======================================  ===================================
a client's shuffles (padded round)      (s, round, client, epoch)
a client run's dropout masks            (s, round, client, 2718)
a packed round's dropout masks          (s, round, 2718)
a client's local DP noise               (s, round, client, 104729)
the security tail's attack draw         (s, 999331, round, 0)
the security tail's defense draw        (s, 999331, round, 1)
pack-time data poisoning of a client    (s + 2027, client)
the attacker's list hooks               (s + 2027,), drawn in turn
the defender's list hooks               (s + 1013,), drawn in turn
central DP and ``add_noise``            (s + 7919,), drawn in turn
FedGAN's latents of a client run        (s, 6011, round, client), on the CPU
FedGAN's health draw of a round         (s, 6013, round), on the CPU
DARTS's ``init_alphas``                 (s, 3571), on the CPU
vertical FL's weights of a party        (s, 8161, party), on the CPU
the in-mesh vertical FL's weights       (s, 8171), on the CPU
======================================  ===================================

Model inits take ``init_variables``' generator seeded with one int.  The
in-mesh rounds of this slice draw as their ``sp`` twins do: the in-mesh
FedGKT's edge proto from ``s`` and its server tower from ``s + 1`` (JAX:
``PRNGKey(s)`` and ``fold_in(PRNGKey(s), 1)``), the in-mesh hierarchical
and Turbo-Aggregate rounds' model from ``s``, and split NN's front and back
from 0 and 999.

The same tuple gives the same draws on one device type; a CUDA generator
draws other numbers than a CPU one.  The streams marked "on the CPU" draw
from a CPU generator and move the draw to the run's device, so a run on the
card and one on the CPU start from the same numbers.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# the salts of the structural members' streams (table above)
GAN_LATENT_SALT = 6011
GAN_HEALTH_SALT = 6013
ALPHAS_SALT = 3571
VFL_WEIGHT_SALT = 8161
VFL_INMESH_WEIGHT_SALT = 8171


def seeded_generator(seed: Sequence[int], device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from a tuple of ints."""
    state = np.random.SeedSequence([int(s) for s in seed]).generate_state(2, np.uint32)
    gen = torch.Generator(device=torch.device(device))
    return gen.manual_seed(int(state[0]) << 32 | int(state[1]))
