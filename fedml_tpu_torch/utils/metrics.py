"""Minimal metrics sink used by the port's runtimes (copy of fedml_tpu/utils/metrics.py).

Stands in for the reference's ``mlops.log`` → MQTT/wandb fan-out
(``core/mlops/__init__.py:152``): appends JSON lines to
``tracking_args.log_file_dir`` and mirrors to python logging.  The full MLOps
event bus is not ported yet.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("fedml_tpu_torch.metrics")


class MetricsLogger:
    def __init__(self, args: Any = None):
        self.run_id = str(getattr(args, "run_id", "0")) if args is not None else "0"
        log_dir = getattr(args, "log_file_dir", None) if args is not None else None
        self._fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._path = os.path.join(log_dir, f"metrics_{self.run_id}.jsonl")
            self._fh = open(self._path, "a")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = dict(metrics)
        rec.setdefault("ts", round(time.time(), 3))
        if step is not None:
            rec.setdefault("step", step)
        logger.info("%s", rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
