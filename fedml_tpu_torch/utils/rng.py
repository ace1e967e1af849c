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
======================================  ===================================

The same tuple gives the same draws on one device type; a CUDA generator
draws other numbers than a CPU one.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def seeded_generator(seed: Sequence[int], device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from a tuple of ints."""
    state = np.random.SeedSequence([int(s) for s in seed]).generate_state(2, np.uint32)
    gen = torch.Generator(device=torch.device(device))
    return gen.manual_seed(int(state[0]) << 32 | int(state[1]))
