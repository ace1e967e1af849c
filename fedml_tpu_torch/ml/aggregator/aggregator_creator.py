"""ServerAggregator factory (counterpart of
``fedml_tpu/ml/aggregator/aggregator_creator.py``): the default branch, whose
masked eval computes token-level metrics for next-word prediction, sequence
tagging and node classification, and the task-eval branch for tag
prediction, span extraction, seq2seq, link prediction, multi-task
prediction, graph regression, segmentation, detection and anomaly
detection, which evaluates through the task trainer's ``test``."""

from __future__ import annotations

from ...core.alg_frame.server_aggregator import ServerAggregator
from ..trainer.trainer_creator import (
    _AE_DATASETS, _DET_DATASETS, _LINKPRED_DATASETS, _MTL_DATASETS, _REG_DATASETS,
    _S2S_DATASETS, _SEG_DATASETS, _SPAN_DATASETS, _TAG_DATASETS, trainer_class,
)
from .default_aggregator import DefaultServerAggregator

_TRAINER_EVAL_DATASETS = (_TAG_DATASETS | _SPAN_DATASETS | _S2S_DATASETS | _LINKPRED_DATASETS
                          | _MTL_DATASETS | _REG_DATASETS | _SEG_DATASETS | _DET_DATASETS
                          | _AE_DATASETS)


class _TrainerEvalAggregator(DefaultServerAggregator):
    """Evaluates through a task trainer's ``test`` (tag BCE metrics, span
    exact match, seq2seq token accuracy and exact match, the labeled-entry
    hits of link and multi-task prediction, regression SSE and hits, pixel
    accuracy and mIoU, detection class accuracy and box IoU, the anomaly
    threshold's hits and recall).  The probe
    trainer is built once."""

    def __init__(self, model, args, trainer_cls):
        super().__init__(model, args)
        self._probe = trainer_cls(model, args)

    def test(self, test_data, device, args):
        self._probe.set_model_params(self.variables)
        return self._probe.test(test_data, device, args)


def create_server_aggregator(model, args) -> ServerAggregator:
    dataset = str(getattr(args, "dataset", "")).lower()
    if dataset in _TRAINER_EVAL_DATASETS:
        return _TrainerEvalAggregator(model, args, trainer_class(dataset))
    return DefaultServerAggregator(model, args)
