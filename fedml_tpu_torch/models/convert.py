"""Weights carried across: the JAX package's TransformerLM variables onto the
port's module.

The flax variables arrive as a nested dict of numpy arrays (``{"params":
{...}}`` or the bare params dict).  The mapping:

==========================================  ==========================================
flax leaf                                   torch parameter
==========================================  ==========================================
``embed/embedding`` [V, d]                  ``embed.weight``, unchanged
``layer{i}/qkv/kernel`` [d, 3, H, Dh]       ``layers.{i}.qkv.weight`` [3*H*Dh, d]
``layer{i}/out_proj/kernel`` [H, Dh, d]     ``layers.{i}.out_proj.weight`` [d, H*Dh]
``wi_gate``, ``wi_up``, ``wo``,             ``nn.Linear.weight``, transposed
``lm_head`` ``kernel`` [in, out]
``attn_norm``, ``mlp_norm``,                the RMSNorm ``weight``
``final_norm`` ``scale``
==========================================  ==========================================
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _kernel_to_weight(kernel: np.ndarray, in_dims: int) -> np.ndarray:
    """A flax kernel whose first ``in_dims`` axes are inputs -> [out, in]."""
    shape = kernel.shape
    n_in = int(np.prod(shape[:in_dims]))
    return kernel.reshape(n_in, -1).T


def transformer_state_from_flax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """{torch parameter name: numpy array} for a flax TransformerLM tree."""
    params = variables.get("params", variables)
    out: Dict[str, np.ndarray] = {
        "embed.weight": np.asarray(params["embed"]["embedding"]),
        "final_norm.weight": np.asarray(params["final_norm"]["scale"]),
        "lm_head.weight": _kernel_to_weight(np.asarray(params["lm_head"]["kernel"]), 1),
    }
    i = 0
    while f"layer{i}" in params:
        p = params[f"layer{i}"]
        pre = f"layers.{i}."
        out[pre + "attn_norm.weight"] = np.asarray(p["attn_norm"]["scale"])
        out[pre + "mlp_norm.weight"] = np.asarray(p["mlp_norm"]["scale"])
        out[pre + "qkv.weight"] = _kernel_to_weight(np.asarray(p["qkv"]["kernel"]), 1)
        out[pre + "out_proj.weight"] = _kernel_to_weight(np.asarray(p["out_proj"]["kernel"]), 2)
        for name in ("wi_gate", "wi_up", "wo"):
            out[pre + f"{name}.weight"] = _kernel_to_weight(np.asarray(p[name]["kernel"]), 1)
        i += 1
    return out


def variables_from_flax(variables: Mapping[str, Any], module: nn.Module,
                        device: torch.device) -> Dict[str, torch.Tensor]:
    """The port's variables dict (parameter name -> tensor on ``device``) for
    ``module`` from a flax tree; raises on any missing or misshapen leaf."""
    state = transformer_state_from_flax(variables)
    out = {}
    for name, p in module.named_parameters():
        if name not in state:
            raise KeyError(f"flax tree has no leaf for {name}")
        arr = np.array(state.pop(name), copy=True, order="C")
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: flax leaf {arr.shape} vs parameter {tuple(p.shape)}")
        out[name] = torch.from_numpy(arr).to(device=device, dtype=p.dtype)
    if state:
        raise KeyError(f"flax leaves with no parameter: {sorted(state)}")
    return out
