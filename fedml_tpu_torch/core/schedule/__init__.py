"""Heterogeneity-aware client→device scheduling: a verbatim copy of
``fedml_tpu/core/schedule/`` (numpy only), so the port lays out each round's
clients exactly as the JAX package does.

``SeqTrainScheduler`` assigns per-client costs to device slots (LPT plus an
exchange refinement) and ``RuntimeEstimator`` fits the per-step cost from
observed round times.  On one card there is one slot, so the schedule is the
order of the clients in the round: heaviest first (``np.argsort(-costs)``).
That order does not depend on the measured times: the costs are step or
sample counts, or ``a·count`` with a fitted ``a > 0``, and every comparison
comes out the same either way.
"""

from .runtime_estimate import RuntimeEstimator, linear_fit
from .seq_train_scheduler import SeqTrainScheduler

__all__ = ["RuntimeEstimator", "linear_fit", "SeqTrainScheduler"]
