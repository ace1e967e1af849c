"""ServerAggregator factory (counterpart of
``fedml_tpu/ml/aggregator/aggregator_creator.py``): the default branch, whose
masked eval computes token-level metrics for next-word prediction.  The
task-specific eval aggregators come with their trainers (ROADMAP.md queue A,
item 14)."""

from __future__ import annotations

from ...core.alg_frame.server_aggregator import ServerAggregator
from ..trainer.trainer_creator import (
    _AE_DATASETS, _DET_DATASETS, _LINKPRED_DATASETS, _MTL_DATASETS, _REG_DATASETS,
    _S2S_DATASETS, _SEG_DATASETS, _SPAN_DATASETS, _TAG_DATASETS,
)
from .default_aggregator import DefaultServerAggregator

_TASK_EVAL_DATASETS = (_TAG_DATASETS | _SPAN_DATASETS | _DET_DATASETS | _S2S_DATASETS
                       | _LINKPRED_DATASETS | _MTL_DATASETS | _AE_DATASETS | _REG_DATASETS
                       | _SEG_DATASETS)


def create_server_aggregator(model, args) -> ServerAggregator:
    dataset = str(getattr(args, "dataset", "")).lower()
    if dataset in _TASK_EVAL_DATASETS:
        raise NotImplementedError(
            f"the task eval of dataset {dataset!r} is not ported yet "
            "(ROADMAP.md queue A, item 14)")
    return DefaultServerAggregator(model, args)
