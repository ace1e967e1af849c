"""Weights carried across: the JAX package's TransformerLM, NLP encoder,
ResNet, LogisticRegression, GCN and vision-zoo variables onto the port's
modules.

The flax variables arrive as a nested dict of numpy arrays (``{"params":
{...}}`` or the bare params dict).  The TransformerLM's mapping:

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

The encoders of ``models/nlp.py`` share the TransformerLM's ``embed``,
``layer{i}`` and ``final_norm`` leaves, and end in one dense head with bias
instead of ``lm_head``: ``cls_head``, ``tag_head`` or ``span_head``, its
``kernel`` [in, out] to ``{head}.weight`` (transposed) and its ``bias`` to
``{head}.bias``.

Every other family names its modules as flax does, so each leaf maps by
``flax_leaf``'s rule below, read backwards (``params_state_from_flax``):
the ResNets (``conv_init``, ``stage{s}_block{b}/{conv1,conv2,proj,norm1,
norm2,norm_proj}``, ``classifier``), the ``LogisticRegression``
(``linear``), the GCNs (``gc{i}``, ``readout``, ``embed``, ``node_head``,
``reg_head`` and the link predictor's 0-d ``score_bias``) and the vision
zoo (``models/{cnn,vgg,mobilenet,efficientnet,unet,detection,rnn}.py``,
``MLP``) and the structural members' models
(``models/{gan,darts,gkt}.py``), auto-names included (``block3.Conv_1``,
``MBConv_2.SqueezeExcite_0.Dense_0``, ``LSTMCell_0.hf``,
``MixedOp_3.GroupNorm_1``).  A GCN's ``embed`` is a dense layer, not an
embedding: the rule tells the two apart by the ``gc0`` layer beside it.  A
transposed convolution's weight (``ConvTranspose_{i}``, the GAN's
``deconv1`` and ``deconv2``) is kept in flax's orientation ([in, out, kh,
kw], ``models/unet.py``): its kernel [kh, kw, in, out] permutes by (2, 3, 0,
1) with no flip.

The way back, one rule for the families (``flax_leaf``): a parameter
``a.b.weight`` is the leaf ``a/b/kernel`` (a 4-D convolution weight
permuted OIHW -> HWIO, a 2-D dense weight transposed), ``a/b/embedding``
(the embedding, unchanged) or ``a/b/scale`` (a norm's 1-D weight); ``.bias``
is ``bias``; ``layers.{i}`` is ``layer{i}``.  A kernel that flax keeps in
more axes ([d, 3, H, Dh], [H, Dh, d]) has the same row-major order as the
transposed weight.  ``FlatLayout`` lays a variables dict out as one vector
in the order of ``jax.flatten_util.ravel_pytree`` over the flax tree (keys
sorted at every level), so a row of the port's client matrix matches the
JAX package's column for column.

BatchNorm's running averages (``models/resnet.py``'s ``BatchNorm``) are
buffers ``a.b.mean`` and ``a.b.var``, flax's ``batch_stats/a/b/mean`` and
``.../var``; they travel in the variables dict beside the parameters.
``ravel_pytree`` sorts ``batch_stats`` before ``params``, so every buffer's
columns come before the first parameter's, as in the JAX package, whose
defenses, security tail and DP ravel the whole variables.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def _kernel_to_weight(kernel: np.ndarray, in_dims: int) -> np.ndarray:
    """A flax kernel whose first ``in_dims`` axes are inputs -> [out, in]."""
    shape = kernel.shape
    n_in = int(np.prod(shape[:in_dims]))
    return kernel.reshape(n_in, -1).T


# the names of transposed convolutions (models/unet.py, models/gan.py)
_TRANSPOSED = ("ConvTranspose", "deconv")
# the encoders' dense heads (models/nlp.py), each with a bias
ENCODER_HEADS = ("cls_head", "tag_head", "span_head")
# flax BatchNorm's batch_stats leaves: the port's buffer names end in them
BATCH_STATS = ("mean", "var")


def is_batch_stat(name: str) -> bool:
    """Whether a variables entry is a BatchNorm running average (flax's
    ``batch_stats`` collection) rather than a parameter: the one rule, which
    ``module_state`` holds every module to."""
    return name.rsplit(".", 1)[-1] in BATCH_STATS


def module_state(module: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of the module's parameters, then its buffers (the
    BatchNorm running averages): the entries of its variables dict.  Raises
    if a buffer's name does not read as a batch stat, or a parameter's does,
    so the name rule and the module's own split cannot drift apart."""
    params, buffers = list(module.named_parameters()), list(module.named_buffers())
    stray = ([n for n, _ in params if is_batch_stat(n)]
             + [n for n, _ in buffers if not is_batch_stat(n)])
    if stray:
        raise ValueError(f"entries that is_batch_stat misreads: {stray}")
    return params + buffers


def transformer_state_from_flax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """{torch parameter name: numpy array} for a flax TransformerLM tree, or
    for an NLP encoder's (its head in place of ``lm_head``)."""
    params = variables.get("params", variables)
    out: Dict[str, np.ndarray] = {
        "embed.weight": np.asarray(params["embed"]["embedding"]),
        "final_norm.weight": np.asarray(params["final_norm"]["scale"]),
    }
    if "lm_head" in params:
        out["lm_head.weight"] = _kernel_to_weight(np.asarray(params["lm_head"]["kernel"]), 1)
    for head in ENCODER_HEADS:
        if head in params:
            out[f"{head}.weight"] = np.asarray(params[head]["kernel"]).T
            out[f"{head}.bias"] = np.asarray(params[head]["bias"])
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


def params_state_from_flax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """{torch parameter or buffer name: numpy array} for a flax tree whose
    module names are the torch ones (every family but the TransformerLM's):
    each ``params`` leaf by ``flax_leaf``'s rule, each ``batch_stats`` leaf
    ``a/b/mean`` to the buffer ``a.b.mean``."""
    params = variables.get("params", variables)
    dense_embed = "gc0" in params  # a GCN
    out: Dict[str, np.ndarray] = {}

    def walk(tree, path):
        for key, leaf in tree.items():
            if isinstance(leaf, Mapping):
                walk(leaf, path + (key,))
                continue
            arr = np.asarray(leaf)
            name = ".".join(path + (key if arr.ndim == 0 else
                                    "bias" if key == "bias" else "weight",))
            fpath, perm = flax_leaf(name, arr.ndim, dense_embed)
            if fpath != path + (key,):
                raise KeyError(f"flax leaf {'/'.join(path + (key,))} has no parameter")
            out[name] = arr.transpose(np.argsort(perm)) if arr.ndim else arr

    def walk_stats(tree, path):
        for key, leaf in tree.items():
            if isinstance(leaf, Mapping):
                walk_stats(leaf, path + (key,))
            elif key in BATCH_STATS:
                out[".".join(path + (key,))] = np.asarray(leaf)
            else:
                raise KeyError(f"batch_stats leaf {'/'.join(path + (key,))} has no buffer")
    walk(params, ())
    if params is not variables:
        walk_stats(variables.get("batch_stats", {}), ())
    return out


def state_from_flax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The mapping of any model family: the TransformerLM's and the NLP
    encoders' (told apart by their ``final_norm``), else the one rule."""
    params = variables.get("params", variables)
    if "final_norm" in params:
        return transformer_state_from_flax(params)
    return params_state_from_flax(variables)


def variables_from_flax(variables: Mapping[str, Any], module: nn.Module,
                        device: torch.device) -> Dict[str, torch.Tensor]:
    """The port's variables dict (parameter or buffer name -> tensor on
    ``device``) for ``module`` from a flax tree (``batch_stats`` into the
    BatchNorm buffers); raises on any missing or misshapen leaf."""
    state = state_from_flax(variables)
    out = {}
    for name, p in module_state(module):
        if name not in state:
            raise KeyError(f"flax tree has no leaf for {name}")
        arr = np.array(state.pop(name), copy=True, order="C")
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: flax leaf {arr.shape} vs parameter {tuple(p.shape)}")
        out[name] = torch.from_numpy(arr).to(device=device, dtype=p.dtype)
    if state:
        raise KeyError(f"flax leaves with no parameter: {sorted(state)}")
    return out


def flax_leaf(name: str, ndim: int,
              dense_embed: bool = False) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(flax path under ``params``, permutation of the torch parameter's
    axes into the flax leaf's row-major order) of the parameter ``name``;
    ``dense_embed`` reads an ``embed`` layer as dense (the GCN link
    predictor's) rather than as an embedding.  A BatchNorm buffer's path is
    its path in the variables, ``("batch_stats", ..., "mean" | "var")``."""
    if ndim == 0:  # a bare 0-d parameter (the link predictor's score_bias)
        return (name,), ()
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [f"layer{parts[1]}"] + parts[2:]
    module, leaf = tuple(parts[:-1]), parts[-1]
    if is_batch_stat(name):
        return ("batch_stats",) + module + (leaf,), tuple(range(ndim))
    if leaf == "bias":
        return module + ("bias",), tuple(range(ndim))
    if leaf != "weight":
        raise KeyError(f"no flax leaf for parameter {name}")
    if ndim == 4:  # OIHW -> HWIO; a transposed convolution's [I, O, H, W] -> HWIO
        perm = (2, 3, 0, 1) if module[-1].startswith(_TRANSPOSED) else (2, 3, 1, 0)
        return module + ("kernel",), perm
    if ndim == 2:
        if module[-1] == "embed" and not dense_embed:
            return module + ("embedding",), (0, 1)
        return module + ("kernel",), (1, 0)
    if ndim == 1:
        return module + ("scale",), (0,)
    raise KeyError(f"no flax leaf for parameter {name} of {ndim} axes")


class FlatLayout:
    """A variables dict as one fp32 vector in ``ravel_pytree`` order.

    ``entries`` lists, in that order, each parameter's name, flax path, the
    permutation of its axes, its flax-ordered shape and its column range:
    the BatchNorm buffers first (``batch_stats`` sorts before ``params``),
    then the parameters.  Views and copies keep each parameter's torch
    shape."""

    def __init__(self, shapes: Sequence[Tuple[str, Tuple[int, ...]]]):
        rows = []
        dense_embed = any(name.startswith("gc0.") for name, _ in shapes)  # a GCN
        for name, shape in shapes:
            path, perm = flax_leaf(name, len(shape), dense_embed)
            rows.append((path, name, perm, tuple(shape[p] for p in perm)))
        rows.sort(key=lambda r: (r[0][0] != "batch_stats", r[0]))
        self.entries: List[Tuple[str, Tuple[str, ...], Tuple[int, ...], Tuple[int, ...],
                                 int, int]] = []
        off = 0
        for path, name, perm, fshape in rows:
            n = int(np.prod(fshape, dtype=np.int64))
            self.entries.append((name, path, perm, fshape, off, n))
            off += n
        self.dim = off
        self._by_path = {e[1]: e for e in self.entries}

    @staticmethod
    def of(tree: Mapping[str, Any], lead: int = 0) -> "FlatLayout":
        """The layout of a variables dict (``lead`` leading axes dropped)."""
        return _layout(tuple((k, tuple(v.shape[lead:])) for k, v in tree.items()))

    def entry(self, path: Sequence[str]):
        return self._by_path[tuple(path)]

    def stack_to_mat(self, stack: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """``{name: [n, ...]}`` -> the fp32 ``[n, D]`` matrix."""
        n = next(iter(stack.values())).shape[0]
        return torch.cat([stack[name].permute(0, *(p + 1 for p in perm)).reshape(n, -1).float()
                          for name, _, perm, _, _, _ in self.entries], dim=1)

    def ravel(self, tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return self.stack_to_mat({k: v.unsqueeze(0) for k, v in tree.items()})[0]

    def views(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Views of a ``[D]`` vector, or of each row of ``[n, D]``, in each
        parameter's torch shape (non-contiguous where the axes permute)."""
        lead = tuple(vec.shape[:-1])
        out = {}
        for name, _, perm, fshape, off, n in self.entries:
            inv = tuple(int(i) for i in np.argsort(perm))
            v = vec[..., off:off + n].reshape(lead + fshape)
            out[name] = v.permute((*range(len(lead)), *(len(lead) + i for i in inv)))
        return out

    def unravel(self, vec: torch.Tensor, like: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A ``[D]`` vector as an fp32 dict, each tensor laid out in memory as
        ``like``'s tensor of the same name (its strides)."""
        views = self.views(vec)
        return {k: torch.empty_strided(t.shape, t.stride(), dtype=torch.float32,
                                       device=vec.device).copy_(views[k])
                for k, t in like.items()}


@lru_cache(maxsize=32)
def _layout(shapes: Tuple[Tuple[str, Tuple[int, ...]], ...]) -> FlatLayout:
    return FlatLayout(shapes)
