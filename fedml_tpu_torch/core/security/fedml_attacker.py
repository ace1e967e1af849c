"""Attack dispatcher singleton (counterpart of
``fedml_tpu/core/security/fedml_attacker.py``).

Gated by ``enable_attack`` and ``attack_type``: the server's
``on_before_aggregation`` calls ``attack_model`` to corrupt the collected
updates, and the simulator stamps the data attacks into each malicious
client's shard at pack time (``poison_local_data``).  The malicious set is
``get_byzantine_idxs``, one numpy draw over the population, the JAX
package's to the client.  The attacker's own draws come in turn from a
generator seeded ``random_seed + 2027``; a client's data poisoning draws
from a generator seeded (``random_seed + 2027``, client), so it does not
depend on the order in which clients are packed.  The analysis attacks
(``dlg``, ``invert_gradient``, ``revealing_labels_from_gradients``) are not
ported (ROADMAP.md queue A, item 8: the trust path, what is left).
"""

from __future__ import annotations

import logging
import os
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ...utils.rng import seeded_generator
from . import attack_funcs as A
from .constants import (
    ATTACK_METHOD_BACKDOOR,
    ATTACK_METHOD_BYZANTINE_ATTACK,
    ATTACK_METHOD_DLG,
    ATTACK_METHOD_EDGE_CASE_BACKDOOR,
    ATTACK_METHOD_INVERT_GRADIENT,
    ATTACK_METHOD_LABEL_FLIPPING,
    ATTACK_METHOD_MODEL_REPLACEMENT,
    ATTACK_METHOD_REVEALING_LABELS,
)

_UNSET = object()  # edge-pool cache sentinel (None is a valid cached value)
ATTACK_SALT = 2027
ANALYSIS_REFUSAL = ("the analysis attacks (dlg, invert_gradient, revealing_labels_from_gradients) "
                    "are not ported yet (ROADMAP.md queue A, item 8: the trust path, what is left)")

logger = logging.getLogger(__name__)

_MODEL_ATTACKS = {
    ATTACK_METHOD_BYZANTINE_ATTACK,
    ATTACK_METHOD_MODEL_REPLACEMENT,
    ATTACK_METHOD_BACKDOOR,  # ALIE in-range evasion on the update list
    ATTACK_METHOD_EDGE_CASE_BACKDOOR,  # scaled push projected into a norm ball
}
_DATA_ATTACKS = {
    ATTACK_METHOD_LABEL_FLIPPING,
    ATTACK_METHOD_BACKDOOR,  # trigger-pattern stamping + relabel
    ATTACK_METHOD_EDGE_CASE_BACKDOOR,  # tail-sample relabel
}
_ANALYSIS_ATTACKS = {
    # privacy/analysis primitives: run on ONE intercepted client update
    # (the round loop pulls a victim row off the update stack)
    ATTACK_METHOD_DLG,
    ATTACK_METHOD_INVERT_GRADIENT,
    ATTACK_METHOD_REVEALING_LABELS,
}


class FedMLAttacker:
    _attacker_instance: Optional["FedMLAttacker"] = None

    @classmethod
    def get_instance(cls) -> "FedMLAttacker":
        if cls._attacker_instance is None:
            cls._attacker_instance = cls()
        return cls._attacker_instance

    def __init__(self):
        self.is_enabled = False
        self.attack_type: Optional[str] = None
        self.args = None
        self._edge_pool_cache = _UNSET
        self._gen = seeded_generator((ATTACK_SALT,))
        self._seed = ATTACK_SALT

    def init(self, args: Any) -> None:
        if not getattr(args, "enable_attack", False):
            self.is_enabled = False
            return
        self.args = args
        self.is_enabled = True
        self.attack_type = str(args.attack_type).strip()
        self._seed = int(getattr(args, "random_seed", 0)) + ATTACK_SALT
        self._gen = seeded_generator((self._seed,))
        self._round_clients = None
        self._edge_pool_cache = _UNSET  # re-read edge_case_dir on re-init
        logger.info("attack enabled: %s", self.attack_type)

    def is_attack_enabled(self) -> bool:
        return self.is_enabled

    def is_model_attack(self) -> bool:
        return self.is_enabled and self.attack_type in _MODEL_ATTACKS

    def is_data_poisoning_attack(self) -> bool:
        return self.is_enabled and self.attack_type in _DATA_ATTACKS

    def is_analysis_attack(self) -> bool:
        return self.is_enabled and self.attack_type in _ANALYSIS_ATTACKS

    def get_byzantine_idxs(self, num_clients: int) -> List[int]:
        k = int(getattr(self.args, "byzantine_client_num", 1))
        # salt the stream: round-0 client sampling draws choice(N, m) from
        # np.random.seed(round_idx) and the default random_seed is also 0 —
        # an unsalted draw here would make the byzantine set exactly the
        # round-0 cohort, silently turning "k of N malicious" experiments
        # into "all of round 0 malicious"
        rng = np.random.RandomState(int(getattr(self.args, "random_seed", 0)) + 7919)
        return sorted(rng.choice(num_clients, size=min(k, num_clients), replace=False).tolist())

    def set_round_clients(self, client_ids) -> None:
        """Round loops call this with the round's sampled POPULATION client
        ids (in collection order) so the model-side attack corrupts the same
        clients the data-side poisoning targeted.  Without it, attack_model
        falls back to drawing slot positions — only correct under full
        participation."""
        self._round_clients = [int(c) for c in client_ids]

    def _malicious_slots(self, n_slots: int) -> List[int]:
        round_ids = getattr(self, "_round_clients", None)
        if round_ids is not None and len(round_ids) == n_slots:
            total = int(getattr(self.args, "client_num_in_total", n_slots))
            bad = set(self.get_byzantine_idxs(total))
            return [slot for slot, cid in enumerate(round_ids) if cid in bad]
        return self.get_byzantine_idxs(n_slots)

    # -- hooks ---------------------------------------------------------------
    def attack_model(self, raw_client_grad_list: List[Tuple[float, Any]],
                     extra_auxiliary_info: Any = None) -> List[Tuple[float, Any]]:
        if not self.is_model_attack():
            return raw_client_grad_list
        idxs = self._malicious_slots(len(raw_client_grad_list))
        a = self.args
        if self.attack_type == ATTACK_METHOD_BYZANTINE_ATTACK:
            return A.byzantine_attack(raw_client_grad_list, extra_auxiliary_info, idxs,
                                      mode=str(getattr(a, "attack_mode", "random")),
                                      gen=self._gen)
        if self.attack_type == ATTACK_METHOD_MODEL_REPLACEMENT:
            scale = float(getattr(a, "attack_scale", 10.0))
            out = list(raw_client_grad_list)
            for i in idxs:
                n, p = out[i]
                out[i] = (n, A.model_replacement(p, extra_auxiliary_info, scale))
            return out
        if self.attack_type == ATTACK_METHOD_BACKDOOR:
            # model side of the backdoor: ALIE keeps malicious updates inside
            # the benign per-coordinate range
            return A.alie_attack(raw_client_grad_list, idxs,
                                 num_std=float(getattr(a, "attack_num_std", 1.5)),
                                 mode=str(getattr(a, "attack_mode", "craft")))
        # edge-case backdoor: the scaled push, projected back into an
        # eps-ball around the global model to evade norm-based defenses
        scale = float(getattr(a, "attack_scale", 10.0))
        eps = float(getattr(a, "attack_norm_bound", 5.0))
        out = list(raw_client_grad_list)
        for i in idxs:
            n, p = out[i]
            pushed = A.model_replacement(p, extra_auxiliary_info, scale)
            out[i] = (n, A.project_to_norm_ball(pushed, extra_auxiliary_info, eps))
        return out

    def poison_data(self, labels):
        """Label flipping on a label array (numpy or tensor, returned in kind)."""
        if not self.is_data_poisoning_attack() or self.attack_type != ATTACK_METHOD_LABEL_FLIPPING:
            return labels
        flipped = A.flip_labels(torch.as_tensor(np.asarray(labels)),
                                int(getattr(self.args, "original_class", 1)),
                                int(getattr(self.args, "target_class", 7)))
        return flipped if torch.is_tensor(labels) else flipped.numpy()

    def poison_dataset(self, x, y, logits=None, gen: Optional[torch.Generator] = None):
        """Data side of the backdoor attacks: stamp triggers or relabel
        tails (numpy in, numpy out).  ``logits`` (model outputs on x) drive the
        edge-case selection when no edge-case pool is mounted; without either
        the edge-case variant poisons nothing.  ``gen`` defaults to the
        attacker's own."""
        if not self.is_data_poisoning_attack():
            return x, y
        gen = gen if gen is not None else self._gen
        xt, yt = torch.as_tensor(np.asarray(x)), torch.as_tensor(np.asarray(y))
        target = int(getattr(self.args, "target_class", 0))
        frac = float(getattr(self.args, "poison_fraction", 0.2))
        if self.attack_type == ATTACK_METHOD_BACKDOOR:
            xt, yt = A.poison_backdoor(xt, yt, target, frac, gen=gen)
        elif self.attack_type == ATTACK_METHOD_EDGE_CASE_BACKDOOR:
            pool = self._edge_case_pool(tuple(xt.shape[1:]))
            if pool is not None:
                # edge-case example pools (ARDIS / Southwest pickles): inject
                # mounted edge-case inputs labeled target
                k = max(1, int(frac * len(yt)))
                src, pos = A.edge_case_choice(pool.shape[0], len(yt), k, gen)
                xt, yt = A.inject_edge_cases(xt, yt, pool, target, src, pos)
            elif logits is not None:
                xt, yt = A.poison_edge_cases(xt, yt, torch.as_tensor(np.asarray(logits)),
                                             target, frac)
        return xt.numpy(), yt.numpy()

    def _edge_case_pool(self, sample_shape):
        """Mounted edge-case example pool (``args.edge_case_dir`` pointing at
        reference-format pickles), cached per ``init``; pools are keyed by
        sample shape, so only the matching-shape pool is injected."""
        if self._edge_pool_cache is _UNSET:
            from ...data.loaders import load_edge_case_pool

            root = getattr(self.args, "edge_case_dir", None)
            self._edge_pool_cache = (
                load_edge_case_pool(root) if root and os.path.isdir(root) else None
            )
        pools = self._edge_pool_cache
        if pools is None:
            return None
        pool = pools.get(tuple(sample_shape))
        return None if pool is None else torch.as_tensor(pool)

    def poison_local_data(self, client_idx: int, num_clients: int, x, y, logits=None):
        """Per-client data-poisoning entry the round calls before training:
        this attack's data transformation if ``client_idx`` is malicious (the
        byzantine idxs over the whole population), else the data unchanged.
        The client's draws come from (``random_seed + 2027``, client)."""
        if not self.is_data_poisoning_attack():
            return x, y
        if int(client_idx) not in set(self.get_byzantine_idxs(num_clients)):
            return x, y
        if self.attack_type == ATTACK_METHOD_LABEL_FLIPPING:
            return x, self.poison_data(y)
        return self.poison_dataset(x, y, logits=logits,
                                   gen=seeded_generator((self._seed, int(client_idx))))

    # -- privacy attacks ----------------------------------------------------
    def reconstruct_data(self, *args, **kwargs):
        raise NotImplementedError(ANALYSIS_REFUSAL)

    def analyze_update(self, *args, **kwargs):
        raise NotImplementedError(ANALYSIS_REFUSAL)
