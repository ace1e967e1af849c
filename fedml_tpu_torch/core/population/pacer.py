"""Round pacing arithmetic of the port: a copy of
``fedml_tpu/core/population/pacer.py`` (over-commit and deadline quorum).

Pure arithmetic: how many clients to invite (``ceil(K * overcommit)``) and
how many reports close a round.  The population manager's ``cohort_stats``
record reads ``quorum_for`` and ``overcommit``; the message-plane rounds that
act on them come with ROADMAP.md queue A, item 9a.  Knobs:

* ``pacing_overcommit`` (float >= 1.0, default 1.0) — invite multiplier.
* ``pacing_quorum`` (int >= 0, default 0) — explicit quorum; 0 means the
  target cohort size ``K`` (``client_num_per_round``).
"""

from __future__ import annotations

import math


class RoundPacer:
    def __init__(self, overcommit: float = 1.0, quorum: int = 0):
        self.overcommit = float(overcommit or 1.0)
        self.quorum = int(quorum or 0)
        if self.overcommit < 1.0:
            raise ValueError(
                f"pacing_overcommit must be >= 1.0 (got {self.overcommit})"
            )
        if self.quorum < 0:
            raise ValueError(f"pacing_quorum must be >= 0 (got {self.quorum})")

    @classmethod
    def from_args(cls, args) -> "RoundPacer":
        return cls(
            overcommit=float(getattr(args, "pacing_overcommit", 1.0) or 1.0),
            quorum=int(getattr(args, "pacing_quorum", 0) or 0),
        )

    @property
    def enabled(self) -> bool:
        return self.overcommit > 1.0 or self.quorum > 0

    def invite_count(self, k: int) -> int:
        """``ceil(K * overcommit)`` with a float-noise guard so 1.1 * 10
        does not ceil to 12."""
        return int(math.ceil(int(k) * self.overcommit - 1e-9))

    def quorum_for(self, k: int, invited: int) -> int:
        """Reports needed to close the round: the explicit quorum (or the
        target ``K``), never more than were actually invited, never < 1."""
        q = self.quorum if self.quorum > 0 else int(k)
        return max(1, min(q, int(invited)))

    def __repr__(self) -> str:  # pragma: no cover
        return f"RoundPacer(overcommit={self.overcommit}, quorum={self.quorum})"
