"""Model factory keyed on (model, dataset), counterpart of
``fedml_tpu/models/hub.py``.

``create`` returns the module built on the ``meta`` device: a description with
shapes and no storage, as the flax hub returns an uninitialised module.  The
engine materialises it on the run's device and fills it from a seeded
generator (``ml.engine.train.init_variables``).  The ``lr`` (the default),
``transformer`` and ResNet keys, the FedNLP family's (the encoders of
``models/nlp.py`` and the seq2seq TransformerLM), the FedGraphNN family's
(the GCN heads of ``models/gcn.py``) and the vision zoo's (``cnn``,
``cnn_web``, ``vgg11``/``vgg16``, ``mobilenet``, ``mobilenet_v3``,
``efficientnet``, ``unet``, ``tiny_detector``, ``mlp`` and the ``rnn``
family) are ported, and so are the structural members' (``gan``: the
generator at the default latent width, as the JAX hub builds it; ``darts``;
``gkt_client``, ``gkt_server``), and the IoT autoencoder (``autoencoder``,
``ae``, ``anomaly_ae``).  flax infers a layer's input width at init; here the
dataset's spec gives it (its sample shape, its vocabulary; the GKT server's
input is the client net's default width).
"""

from __future__ import annotations

import logging
import math
from typing import Any

import torch
from torch import nn

logger = logging.getLogger(__name__)

# the models the JAX hub plumbs compute_dtype into; the transformer is not one
_RESNETS = {"resnet20", "resnet56", "resnet18", "resnet18_gn"}


def _in_shape(dataset: str) -> tuple:
    """The shape of one sample of the dataset (flax infers it at init)."""
    from ..data.data_loader import DATASET_SPECS

    return tuple(DATASET_SPECS.get(dataset, {}).get("shape", (32, 32, 3)))


def _spec_int(dataset: str, key: str, default: int) -> int:
    """An integer of the dataset's spec (``vocab``, ``feat_dim``,
    ``num_tasks``), else ``default``."""
    from ..data.data_loader import DATASET_SPECS

    return int(DATASET_SPECS.get(dataset, {}).get(key, default))


def _in_channels(dataset: str) -> int:
    """Input channels of an image dataset (flax infers them at init)."""
    shape = _in_shape(dataset)
    return int(shape[-1]) if len(shape) == 3 else 1


def _image(dataset: str) -> dict:
    """An image model's input: its spatial size and channels."""
    return dict(in_hw=_in_shape(dataset)[:2], in_channels=_in_channels(dataset))


def create(args: Any, output_dim: int) -> nn.Module:
    name = str(getattr(args, "model", "lr")).lower()
    dataset = str(getattr(args, "dataset", "")).lower()

    if _dtype(args) is not torch.float32 and name not in _RESNETS:
        logger.warning(
            "compute_dtype=%s is only plumbed into %s; model %r runs fp32",
            getattr(args, "compute_dtype", None), sorted(_RESNETS), name,
        )
    if name in ("lr", "logistic_regression"):
        from .linear import LogisticRegression

        return LogisticRegression(math.prod(_in_shape(dataset)), output_dim, device="meta")
    if name in ("transformer", "fedtransformer"):
        from .transformer import TransformerConfig, TransformerLM

        return TransformerLM(TransformerConfig(vocab_size=max(output_dim, 256)), device="meta")
    if name in ("transformer_cls", "bert_cls", "distilbert"):
        from .nlp import TransformerClassifier

        return TransformerClassifier(output_dim, vocab_size=_spec_int(dataset, "vocab", 2000),
                                     device="meta")
    if name in ("transformer_tagger", "bert_tagger"):
        from .nlp import TransformerTagger

        return TransformerTagger(output_dim, vocab_size=_spec_int(dataset, "vocab", 2000),
                                 device="meta")
    if name in ("transformer_span", "bert_qa"):
        from .nlp import TransformerSpanExtractor

        # compact head: at CI data scales a wide encoder memorizes spans
        # instead of learning the extraction rule
        return TransformerSpanExtractor(vocab_size=_spec_int(dataset, "vocab", 200), d_model=48,
                                        d_ff=96, device="meta")
    if name in ("transformer_s2s", "bart_s2s", "seq2seq"):
        from .transformer import TransformerConfig, TransformerLM

        # causal decoder-only over [src | SEP | tgt], the loss masked to the
        # target positions: on the card its attention runs K1-K3
        return TransformerLM(TransformerConfig(
            vocab_size=_spec_int(dataset, "vocab", max(output_dim, 64)), d_model=128, n_heads=4,
            n_layers=2, d_ff=256), device="meta")
    if name in ("gcn", "graphsage", "gat"):
        from .gcn import GCN

        return GCN(output_dim, _spec_int(dataset, "feat_dim", 8), device="meta")
    if name in ("gcn_linkpred", "gcn_link_pred"):
        from .gcn import GCNLinkPred

        return GCNLinkPred(_spec_int(dataset, "feat_dim", 8), device="meta")
    if name in ("gcn_nodeclf", "gcn_node"):
        from .gcn import GCNNodeClassifier

        return GCNNodeClassifier(output_dim, _spec_int(dataset, "feat_dim", 8), device="meta")
    if name in ("gcn_reg", "gcn_regressor"):
        from .gcn import GCNRegressor

        return GCNRegressor(_spec_int(dataset, "feat_dim", 8), device="meta")
    if name in ("gcn_mtl", "gcn_multitask"):
        from .gcn import GCN

        # one logit a task
        return GCN(_spec_int(dataset, "num_tasks", output_dim), _spec_int(dataset, "feat_dim", 8),
                   device="meta")
    if name in ("cnn", "cnn_dropout"):
        from .cnn import CNN_DropOut

        return CNN_DropOut(only_digits=(output_dim <= 10), num_classes=output_dim,
                           device="meta", **_image(dataset))
    if name in ("cnn_web",):
        from .cnn import CNN_WEB

        return CNN_WEB(output_dim=output_dim, device="meta", **_image(dataset))
    if name in ("vgg11", "vgg16"):
        from .vgg import VGG

        return VGG(num_classes=output_dim, depth=int(name[3:]),
                   in_channels=_in_channels(dataset), device="meta")
    if name in ("mobilenet", "mobilenet_v1"):
        from .mobilenet import MobileNetV1

        return MobileNetV1(num_classes=output_dim, in_channels=_in_channels(dataset),
                           device="meta")
    if name in ("mobilenet_v3",):
        from .mobilenet import MobileNetV3Small

        return MobileNetV3Small(num_classes=output_dim, in_channels=_in_channels(dataset),
                                device="meta")
    if name in ("efficientnet", "efficientnet_b0"):
        from .efficientnet import EfficientNet

        return EfficientNet(num_classes=output_dim, in_channels=_in_channels(dataset),
                            device="meta")
    if name in ("unet", "deeplabv3", "deeplabv3_plus"):
        from .unet import UNet

        return UNet(num_classes=output_dim, in_channels=_in_channels(dataset), device="meta")
    if name in ("tiny_detector", "yolo_lite"):
        from .detection import TinyDetector

        return TinyDetector(num_classes=output_dim, device="meta", **_image(dataset))
    if name in ("mlp",):
        from .linear import MLP

        return MLP(math.prod(_in_shape(dataset)), output_dim, device="meta")
    if name in ("rnn", "rnn_fedavg", "rnn_originalfedavg", "lstm", "lstm_tagpred"):
        from .rnn import RNN_OriginalFedAvg

        return RNN_OriginalFedAvg(vocab_size=max(output_dim, 90), device="meta")
    if name in ("rnn_fedshakespeare",):
        from .rnn import RNN_FedShakespeare

        return RNN_FedShakespeare(vocab_size=max(output_dim, 90), device="meta")
    if name in ("rnn_stackoverflow", "rnn_nwp"):
        from .rnn import RNN_StackOverFlow

        return RNN_StackOverFlow(vocab_size=output_dim, device="meta")
    if name in ("gan", "mnist_gan"):
        from .gan import MNISTGenerator

        return MNISTGenerator(device="meta")
    if name in ("gkt_client", "resnet8_gkt"):
        from .gkt import GKTClientNet

        return GKTClientNet(num_classes=output_dim, in_channels=_in_channels(dataset),
                            device="meta")
    if name in ("gkt_server", "resnet55_gkt"):
        from .gkt import GKTServerNet

        return GKTServerNet(num_classes=output_dim, device="meta")
    if name in ("darts", "darts_network"):
        from .darts import DARTSNetwork

        return DARTSNetwork(num_classes=output_dim, in_channels=_in_channels(dataset),
                            device="meta")
    if name in _RESNETS:
        from . import resnet

        kw = dict(dtype=_dtype(args), in_channels=_in_channels(dataset), device="meta")
        if name in ("resnet18", "resnet18_gn"):
            return resnet.ResNet18(num_classes=output_dim, norm="gn", **kw)
        blocks = {"resnet20": 3, "resnet56": 9}[name]
        return resnet.CifarResNet(blocks, num_classes=output_dim, norm=_norm(args), **kw)
    if name in ("autoencoder", "ae", "anomaly_ae"):
        from ..data.data_loader import DATASET_SPECS
        from .autoencoder import AutoEncoder

        feat = int(DATASET_SPECS.get(dataset, {}).get("shape", (24,))[0])
        return AutoEncoder(feat_dim=feat, device="meta")
    raise ValueError(f"unknown model {name!r} for dataset {dataset!r}")


def _norm(args: Any) -> str:
    return str(getattr(args, "model_norm", "gn")).lower()


def _parse_dtype(name: str, arg_name: str) -> torch.dtype:
    if name in ("fp32", "float32"):
        return torch.float32
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"unknown {arg_name} {name!r} (use fp32 or bf16)")


def _dtype(args: Any) -> torch.dtype:
    """Compute dtype from ``args.compute_dtype`` ('fp32' or 'bf16')."""
    return _parse_dtype(
        str(getattr(args, "compute_dtype", "fp32") or "fp32").lower(), "compute_dtype"
    )


def data_storage_dtype(args: Any, module: Any = None) -> torch.dtype:
    """Storage dtype of the simulator's packed float dataset (fed_sim
    ``_pack_data``).  When the model casts its input to bf16 at its entry
    (``compute_dtype`` bf16 and a ResNet), storing bf16 halves the per-step
    gather's bytes and gives the model the same input bit for bit:
    bf16(gather(x_fp32)) == gather(bf16(x_fp32)).  ``args.xla_data_dtype`` in
    {auto, fp32, bf16} overrides; ``auto`` (the default) stores bf16 exactly
    when the numerics cannot change, which is checked on the module itself:
    a module that does not compute in bf16 keeps fp32 data."""
    req = str(getattr(args, "xla_data_dtype", "auto") or "auto").lower()
    if req != "auto":
        return _parse_dtype(req, "xla_data_dtype")
    name = str(getattr(args, "model", "lr")).lower()
    if _dtype(args) is not torch.bfloat16 or name not in _RESNETS:
        return torch.float32
    if module is not None and getattr(module, "dtype", None) is not torch.bfloat16:
        return torch.float32
    return torch.bfloat16
