"""Dataset-family tables and the engine loss key per family: the part of
``fedml_tpu/ml/trainer/trainer_creator.py`` the simulator reads.  The task
trainers themselves are ported with the model zoo (ROADMAP.md queue A,
item 14)."""

from __future__ import annotations

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
