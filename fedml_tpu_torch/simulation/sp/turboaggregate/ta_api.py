"""Turbo-Aggregate of the port's ``sp`` simulator (counterpart of
``fedml_tpu/simulation/sp/turboaggregate/ta_api.py``): multi-group
circular secure aggregation (So et al.).

The round's uploads are split into ``ta_group_num`` groups (at most one an
upload) arranged in a ring.  Group g adds its mask m_g to its sample-
weighted partial sum and takes off m_{g-1}, so the masks telescope as the
ring is walked and only the last group's mask is left to take off: the
server only ever sees masked group sums, and the result is the weighted
mean up to roundoff.  The masks are unit normals drawn on the CPU from one
``torch.Generator`` seeded ``random_seed + 404``, whose stream advances
with each round's draw (L groups, each leaf in turn), and moved to the
device, so the card and the CPU draw the same masks (JAX's keys are
device-free too; its stream is ``jax.random``'s, which torch cannot
reproduce).  The draw is ``draw_masks(like, L)``, an attribute a test can
replace to feed other masks through the arithmetic.

The aggregate is this ring, so the before-stage hooks (model attacks and
before-aggregation defenses) and on-aggregation defenses are refused, as
the JAX twin skips them; data poisoning, local DP, the after-aggregation
defense and central DP run as in FedAvg.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from ....core.aggregate import tree_add, tree_scale, tree_sub, tree_sum, tree_zeros_like
from ..fedavg.fedavg_api import BEFORE_DEFENSE, MODEL_ATTACK, ON_DEFENSE, FedAvgAPI

MASK_SALT = 404


class TurboAggregateAPI(FedAvgAPI):
    SKIPPED_HOOKS = (MODEL_ATTACK, BEFORE_DEFENSE, ON_DEFENSE)

    def __init__(self, args, device, dataset, model):
        super().__init__(args, device, dataset, model)
        self.group_num = int(getattr(args, "ta_group_num", 2))
        self._mask_gen = torch.Generator().manual_seed(
            int(getattr(args, "random_seed", 0)) + MASK_SALT)
        self.draw_masks = self._draw_masks

    def _draw_masks(self, like, n_groups: int) -> List[Any]:
        """``n_groups`` trees of unit normals shaped as ``like``, drawn in turn
        on the CPU and moved to each leaf's device."""
        return [{k: torch.randn(v.shape, generator=self._mask_gen).to(v.device)
                 for k, v in like.items()} for _ in range(n_groups)]

    def server_update(self, w_locals: List[Tuple[float, Any]]) -> Any:
        # a ring of groups; group g adds m_g and takes off m_{g-1}
        n_groups = min(self.group_num, len(w_locals))
        groups = np.array_split(np.arange(len(w_locals)), n_groups)
        masks = self.draw_masks(w_locals[0][1], n_groups)
        total_n = sum(n for n, _ in w_locals)
        running = tree_zeros_like(w_locals[0][1])
        prev_mask = None
        for g, members in enumerate(groups):
            group_sum = tree_sum([tree_scale(w_locals[int(i)][1], w_locals[int(i)][0] / total_n)
                                  for i in members])
            masked = tree_add(group_sum, masks[g])
            if prev_mask is not None:  # take off the previous group's mask
                masked = tree_sub(masked, prev_mask)
            running = tree_add(running, masked)
            prev_mask = masks[g]
        # the last group's mask is left: take it off
        return self.aggregator.on_after_aggregation(tree_sub(running, prev_mask))
