"""The port stands alone and runs on the card unless asked otherwise.

* Importing the port and every module of its slice pulls in neither JAX nor
  any module of the JAX package (checked in a fresh interpreter).
* ``device.get_device`` gives the CPU only when the config asks for it.
* A kernel wrapper handed a CPU tensor raises; it never falls back.
"""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from fedml_tpu_torch import device as port_device
from fedml_tpu_torch.ops import flash_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "fedml_tpu_torch",
    "fedml_tpu_torch.arguments",
    "fedml_tpu_torch.constants",
    "fedml_tpu_torch.device",
    "fedml_tpu_torch.runner",
    "fedml_tpu_torch.data.data_loader",
    "fedml_tpu_torch.data.data_loader_cross_silo",
    "fedml_tpu_torch.data.loaders",
    "fedml_tpu_torch.data.synthetic",
    "fedml_tpu_torch.centralized",
    "fedml_tpu_torch.centralized.centralized_trainer",
    "fedml_tpu_torch.core.async_fl",
    "fedml_tpu_torch.core.async_fl.buffer",
    "fedml_tpu_torch.core.data.noniid_partition",
    "fedml_tpu_torch.core.distributed.collective",
    "fedml_tpu_torch.core.distributed.topology.topology_manager",
    "fedml_tpu_torch.core.dp.budget_accountant",
    "fedml_tpu_torch.core.dp.fedml_differential_privacy",
    "fedml_tpu_torch.core.dp.mechanisms",
    "fedml_tpu_torch.core.population",
    "fedml_tpu_torch.core.population.manager",
    "fedml_tpu_torch.core.population.pacer",
    "fedml_tpu_torch.core.population.policies",
    "fedml_tpu_torch.core.population.registry",
    "fedml_tpu_torch.core.population.stacked",
    "fedml_tpu_torch.core.schedule",
    "fedml_tpu_torch.core.security.attack_funcs",
    "fedml_tpu_torch.core.security.constants",
    "fedml_tpu_torch.core.security.defense_funcs",
    "fedml_tpu_torch.core.security.fedml_attacker",
    "fedml_tpu_torch.core.security.fedml_defender",
    "fedml_tpu_torch.core.security.stacked",
    "fedml_tpu_torch.core.aggregate",
    "fedml_tpu_torch.core.alg_frame.client_trainer",
    "fedml_tpu_torch.core.alg_frame.params",
    "fedml_tpu_torch.core.alg_frame.server_aggregator",
    "fedml_tpu_torch.core.sampling",
    "fedml_tpu_torch.ml.engine.train",
    "fedml_tpu_torch.ml.engine.packed",
    "fedml_tpu_torch.ml.trainer.ae_trainer",
    "fedml_tpu_torch.ml.trainer.cls_trainer",
    "fedml_tpu_torch.ml.trainer.det_trainer",
    "fedml_tpu_torch.ml.trainer.seg_trainer",
    "fedml_tpu_torch.ml.trainer.graph_trainers",
    "fedml_tpu_torch.ml.trainer.nwp_trainer",
    "fedml_tpu_torch.ml.trainer.reg_trainer",
    "fedml_tpu_torch.ml.trainer.s2s_trainer",
    "fedml_tpu_torch.ml.trainer.span_trainer",
    "fedml_tpu_torch.ml.trainer.tag_trainer",
    "fedml_tpu_torch.ml.trainer.trainer_creator",
    "fedml_tpu_torch.ml.aggregator.aggregator_creator",
    "fedml_tpu_torch.ml.aggregator.default_aggregator",
    "fedml_tpu_torch.models.autoencoder",
    "fedml_tpu_torch.models.cnn",
    "fedml_tpu_torch.models.darts",
    "fedml_tpu_torch.models.detection",
    "fedml_tpu_torch.models.efficientnet",
    "fedml_tpu_torch.models.gan",
    "fedml_tpu_torch.models.gcn",
    "fedml_tpu_torch.models.gkt",
    "fedml_tpu_torch.models.hub",
    "fedml_tpu_torch.models.linear",
    "fedml_tpu_torch.models.mobilenet",
    "fedml_tpu_torch.models.nlp",
    "fedml_tpu_torch.models.rnn",
    "fedml_tpu_torch.models.unet",
    "fedml_tpu_torch.models.vgg",
    "fedml_tpu_torch.models.transformer",
    "fedml_tpu_torch.models.resnet",
    "fedml_tpu_torch.models.convert",
    "fedml_tpu_torch.ops.build",
    "fedml_tpu_torch.ops.flash_attention",
    "fedml_tpu_torch.ops.variants",
    "fedml_tpu_torch.parallel",
    "fedml_tpu_torch.parallel.mesh",
    "fedml_tpu_torch.parallel.ring_attention",
    "fedml_tpu_torch.parallel.seq_parallel",
    "fedml_tpu_torch.simulation.simulator",
    "fedml_tpu_torch.simulation.mpi_proc",
    "fedml_tpu_torch.simulation.mpi_proc.mpi_sim",
    "fedml_tpu_torch.simulation.sp",
    "fedml_tpu_torch.simulation.sp.fedavg.fedavg_api",
    "fedml_tpu_torch.simulation.sp.fedopt.fedopt_api",
    "fedml_tpu_torch.simulation.sp.fedprox.fedprox_api",
    "fedml_tpu_torch.simulation.sp.fednova.fednova_api",
    "fedml_tpu_torch.simulation.sp.fedsgd.fedsgd_api",
    "fedml_tpu_torch.simulation.sp.scaffold.scaffold_api",
    "fedml_tpu_torch.simulation.sp.feddyn.feddyn_api",
    "fedml_tpu_torch.simulation.sp.async_fedavg.async_fedavg_api",
    "fedml_tpu_torch.simulation.sp.async_fedavg.fedbuff_api",
    "fedml_tpu_torch.simulation.sp.hierarchical_fl.hier_api",
    "fedml_tpu_torch.simulation.sp.decentralized.decentralized_api",
    "fedml_tpu_torch.simulation.sp.turboaggregate.ta_api",
    "fedml_tpu_torch.simulation.sp.spreadgnn.spreadgnn_api",
    "fedml_tpu_torch.simulation.sp.fedseg.fedseg_api",
    "fedml_tpu_torch.simulation.sp.fedgan.fedgan_api",
    "fedml_tpu_torch.simulation.sp.fednas.fednas_api",
    "fedml_tpu_torch.simulation.sp.fedgkt.gkt_api",
    "fedml_tpu_torch.simulation.sp.split_nn.split_nn_api",
    "fedml_tpu_torch.simulation.sp.classical_vertical_fl.vfl_api",
    "fedml_tpu_torch.simulation.xla.algorithms",
    "fedml_tpu_torch.simulation.xla.decentralized",
    "fedml_tpu_torch.simulation.xla.fed_sim",
    "fedml_tpu_torch.simulation.xla.gan_nas",
    "fedml_tpu_torch.simulation.xla.hierarchical",
    "fedml_tpu_torch.simulation.xla.split",
    "fedml_tpu_torch.simulation.xla.turbo",
    "fedml_tpu_torch.utils.metrics",
    "fedml_tpu_torch.utils.rng",
]

_PROBE = """
import importlib, json, sys
for name in %r:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "fedml_tpu"))
print(json.dumps(bad))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE % SLICE_MODULES], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120, check=True)
    # "fedml_tpu_torch" splits to its own first component, so only the JAX
    # package's modules (and JAX's own) can land in this list
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_get_device_gives_the_cpu_only_when_asked(monkeypatch):
    assert port_device.get_device(types.SimpleNamespace(device_type="cpu")) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in (types.SimpleNamespace(), types.SimpleNamespace(device_type="gpu"), None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_device.get_device(args)


@pytest.mark.parametrize("entry", ["fwd", "dq", "dkv", "shard_update"])
def test_cuda_entry_refuses_cpu_tensors(entry):
    q, k, v, do = (torch.zeros(1, 8, 1, 32) for _ in range(4))
    lse = delta = torch.zeros(1, 1, 8)
    pos = torch.arange(8, dtype=torch.int32)
    calls = {
        "fwd": lambda: fa.flash_forward_cuda(q, k, v, True),
        "dq": lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, True),
        "dkv": lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True),
        "shard_update": lambda: fa.flash_shard_update_cuda(q, k, v, pos, pos, lse, delta, do,
                                                           True),
    }
    before = dict(fa.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        calls[entry]()
    assert fa.LAUNCHES == before


def test_unported_model_raises_with_its_roadmap_item():
    """BatchNorm (the ResNets', MobileNet's) builds, its running averages as
    buffers named by their flax ``batch_stats`` paths; the vision zoo, the
    structural members' models and the autoencoder build."""
    from fedml_tpu_torch.models import convert, hub
    from fedml_tpu_torch.models.mobilenet import MobileNetV1, MobileNetV3Small

    model = hub.create(types.SimpleNamespace(model="resnet56", dataset="cifar10",
                                             model_norm="bn"), 10)
    paths = {convert.flax_leaf(n, b.dim())[0] for n, b in model.named_buffers()}
    assert len(paths) == 2 * 57  # a mean and a var for each of ResNet-56's 57 norms
    assert ("batch_stats", "stage2_block8", "norm2", "var") in paths
    assert all(p[0] == "batch_stats" and p[-1] in ("mean", "var") for p in paths)
    for cls in (MobileNetV1, MobileNetV3Small):
        buffers = dict(cls(10, norm="bn", device="meta").named_buffers())
        assert "norm_init.mean" in buffers and "norm_init.var" in buffers
        assert {n.rsplit(".", 1)[-1] for n in buffers} == {"mean", "var"}
    for name, cls in (("cnn", "CNN_DropOut"), ("gan", "MNISTGenerator"), ("darts", "DARTSNetwork"),
                      ("gkt_client", "GKTClientNet"), ("gkt_server", "GKTServerNet"),
                      ("autoencoder", "AutoEncoder")):
        assert type(hub.create(types.SimpleNamespace(model=name, dataset="femnist"), 62)).__name__ == cls
