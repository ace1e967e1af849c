"""Trainer factory (counterpart of ``fedml_tpu/ml/trainer/trainer_creator.py``):
the dataset-family tables, the engine loss key per family, and
``create_model_trainer``.  The classification, next-word-prediction /
sequence-tagging (node classification too: [B, N] node labels), tag-prediction,
span-extraction, seq2seq, link-prediction, multi-task, regression,
segmentation (the ``ce`` loss over [B, H, W] masks), detection and
anomaly-detection (the autoencoder's) trainers are ported.

Every trainer takes the grad hook it is given: the port's SCAFFOLD and
FedDyn build their hooked trainer here, so the client loss is the
dataset's (their JAX twins build the classification trainer)."""

from __future__ import annotations

from ...core.alg_frame.client_trainer import ClientTrainer

_NWP_DATASETS = {"shakespeare", "fed_shakespeare", "stackoverflow_nwp"}
_TAG_DATASETS = {"stackoverflow_lr", "nuswide", "nus_wide"}
# per-token classification reuses the NWP trainer (same masked per-token CE)
_SEQTAG_DATASETS = {"onto_tagging", "wikiner", "ego_nodeclf"}
_REG_DATASETS = {"freesolv", "esol", "lipophilicity"}
_SPAN_DATASETS = {"squad_span"}
_DET_DATASETS = {"synthetic_det", "coco_det"}
_S2S_DATASETS = {"synthetic_s2s", "cornell_movie_dialogue"}
_LINKPRED_DATASETS = {"ego_linkpred", "recsys_linkpred"}
_MTL_DATASETS = {"moleculenet_mtl"}
_AE_DATASETS = {"iot_anomaly", "nbaiot"}
_SEG_DATASETS = {"synthetic_seg", "fets2021", "pascal_voc"}


def loss_kind_for_dataset(dataset: str) -> str:
    """Engine loss key for a dataset family (``bce`` datasets are not mapped
    here: their label conversion lives in the tag trainer)."""
    dataset = dataset.lower()
    if dataset in _SPAN_DATASETS:
        return "span"
    if dataset in _DET_DATASETS:
        return "det"
    if dataset in _S2S_DATASETS:
        return "s2s"
    if dataset in _LINKPRED_DATASETS:
        return "linkpred"
    if dataset in _MTL_DATASETS:
        return "mtl_bce"
    if dataset in _AE_DATASETS or dataset in _REG_DATASETS:
        return "mse"
    return "ce"


def trainer_class(dataset: str):
    """The ported trainer class of a dataset family (raises for the others)."""
    dataset = dataset.lower()
    if dataset in _NWP_DATASETS or dataset in _SEQTAG_DATASETS:
        from .nwp_trainer import ModelTrainerNWP

        return ModelTrainerNWP
    if dataset in _TAG_DATASETS:
        from .tag_trainer import ModelTrainerTAGPred

        return ModelTrainerTAGPred
    if dataset in _SPAN_DATASETS:
        from .span_trainer import ModelTrainerSpan

        return ModelTrainerSpan
    if dataset in _S2S_DATASETS:
        from .s2s_trainer import ModelTrainerS2S

        return ModelTrainerS2S
    if dataset in _LINKPRED_DATASETS:
        from .graph_trainers import ModelTrainerLinkPred

        return ModelTrainerLinkPred
    if dataset in _MTL_DATASETS:
        from .graph_trainers import ModelTrainerMTL

        return ModelTrainerMTL
    if dataset in _REG_DATASETS:
        from .reg_trainer import ModelTrainerReg

        return ModelTrainerReg
    if dataset in _DET_DATASETS:
        from .det_trainer import ModelTrainerDET

        return ModelTrainerDET
    if dataset in _SEG_DATASETS:
        from .seg_trainer import ModelTrainerSeg

        return ModelTrainerSeg
    if dataset in _AE_DATASETS:
        from .ae_trainer import ModelTrainerAE

        return ModelTrainerAE
    from .cls_trainer import ModelTrainerCLS

    return ModelTrainerCLS


def create_model_trainer(model, args, grad_hook=None) -> ClientTrainer:
    return trainer_class(str(getattr(args, "dataset", "")))(model, args, grad_hook=grad_hook)
