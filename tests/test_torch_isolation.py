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
    "fedml_tpu_torch.data.loaders",
    "fedml_tpu_torch.data.synthetic",
    "fedml_tpu_torch.core.data.noniid_partition",
    "fedml_tpu_torch.core.population",
    "fedml_tpu_torch.core.alg_frame.server_aggregator",
    "fedml_tpu_torch.ml.engine.train",
    "fedml_tpu_torch.ml.trainer.trainer_creator",
    "fedml_tpu_torch.ml.aggregator.aggregator_creator",
    "fedml_tpu_torch.ml.aggregator.default_aggregator",
    "fedml_tpu_torch.models.hub",
    "fedml_tpu_torch.models.transformer",
    "fedml_tpu_torch.models.convert",
    "fedml_tpu_torch.ops.build",
    "fedml_tpu_torch.ops.flash_attention",
    "fedml_tpu_torch.simulation.simulator",
    "fedml_tpu_torch.simulation.xla.algorithms",
    "fedml_tpu_torch.simulation.xla.fed_sim",
    "fedml_tpu_torch.utils.metrics",
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


@pytest.mark.parametrize("entry", ["fwd", "dq", "dkv"])
def test_cuda_entry_refuses_cpu_tensors(entry):
    q, k, v, do = (torch.zeros(1, 8, 1, 32) for _ in range(4))
    lse = delta = torch.zeros(1, 1, 8)
    calls = {
        "fwd": lambda: fa.flash_forward_cuda(q, k, v, True),
        "dq": lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, True),
        "dkv": lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True),
    }
    before = dict(fa.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        calls[entry]()
    assert fa.LAUNCHES == before


def test_unported_model_raises_with_its_roadmap_item():
    from fedml_tpu_torch.models import hub

    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A, item 3"):
        hub.create(types.SimpleNamespace(model="resnet56", dataset="cifar10"), 10)
