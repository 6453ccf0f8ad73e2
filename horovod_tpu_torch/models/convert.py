"""Carry the JAX package's weights into the port.

``resnet_from_flax(variables)`` turns the ``{"params", "batch_stats"}`` trees
of ``horovod_tpu.models.resnet.ResNet`` (leaves as numpy arrays, or anything
``numpy.asarray`` takes) into a ``state_dict`` for
:class:`horovod_tpu_torch.models.resnet.ResNet` of the same configuration:

- conv kernels go from HWIO to OIHW, the Dense kernel is transposed;
- ``FusedBatchNorm_k``/``BatchNorm_k`` (and ``norm_proj``, ``bn_init``) scale,
  bias, mean and var become weight, bias, running_mean and running_var;
- ``BottleneckBlock_i`` becomes ``blocks.i``, ``Conv_k`` ``conv{k}``,
  ``Dense_0`` ``fc``.

``transformer_from_jax``, ``vit_from_flax`` and ``mlp_from_jax`` do the same
for the decoder LM, the ViT and the MLP, and ``sync_batch_norm_from_flax``
for one ``SyncBatchNorm`` layer.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _module_name(flax_name: str) -> str:
    m = re.fullmatch(r"BottleneckBlock_(\d+)", flax_name)
    if m:
        return f"blocks.{m.group(1)}"
    m = re.fullmatch(r"(?:Fused)?BatchNorm_(\d+)", flax_name)
    if m:
        return f"norm{m.group(1)}"
    m = re.fullmatch(r"Conv_(\d+)", flax_name)
    if m:
        return f"conv{m.group(1)}"
    if flax_name == "Dense_0":
        return "fc"
    return flax_name            # conv_init, bn_init, conv_proj, norm_proj


def _leaves(tree: Mapping, path=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path, key, np.asarray(value, dtype=np.float32)


def _is_norm(name: str) -> bool:
    return re.search(r"BatchNorm|norm_proj|bn_init", name) is not None


def resnet_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's ResNet from the JAX model's variables."""
    out: Dict[str, torch.Tensor] = {}
    unfused = False
    for tree in ("params", "batch_stats"):
        for path, key, arr in _leaves(variables.get(tree, {})):
            module = ".".join(_module_name(p) for p in path)
            if _is_norm(path[-1]):
                name = _BN_LEAVES[key]
                unfused |= path[-1].startswith("BatchNorm")
            elif key == "kernel":
                name = "weight"
                # HWIO -> OIHW; Dense (in, out) -> (out, in)
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            else:
                name = key
            out[f"{module}.{name}"] = torch.tensor(arr)
    if unfused:
        # nn.BatchNorm2d, the unfused variant, also carries a step counter
        for k in [k for k in out if k.endswith(".running_mean")]:
            out[k[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return out


def sync_batch_norm_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's :class:`SyncBatchNorm` from the reference
    module's variables: ``params/{scale,bias}`` become ``weight`` and
    ``bias`` (each only where the layer has it), ``batch_stats/{mean,var}``
    ``running_mean`` and ``running_var``."""
    return {_BN_LEAVES[key]: torch.tensor(arr)
            for tree in ("params", "batch_stats")
            for _, key, arr in _leaves(variables.get(tree, {}))}


def transformer_from_jax(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """State dict of the port's :class:`Transformer` from the reference's
    ``init_params`` tree: ``embed`` and ``ln_f`` as they are, each
    ``layers`` leaf (stacked on a leading n_layers axis) unstacked into
    ``layers.{i}.{name}``. The leaf shapes are the same in both."""
    out = {name: torch.tensor(np.asarray(params[name], dtype=np.float32))
           for name in ("embed", "ln_f")}
    for name, stacked in params["layers"].items():
        arr = np.asarray(stacked, dtype=np.float32)
        if arr.shape[0] != cfg.n_layers:
            raise ValueError(f"layers.{name} stacks {arr.shape[0]} layers, "
                             f"the config has {cfg.n_layers}")
        for i in range(cfg.n_layers):
            out[f"layers.{i}.{name}"] = torch.tensor(arr[i])
    return out


_VIT_MODULES = {"LayerNorm_0": "ln1", "LayerNorm_1": "ln2", "q": "wq",
                "k": "wk", "v": "wv", "o": "wo", "Dense_0": "fc1",
                "Dense_1": "fc2"}
_LN_LEAVES = {"scale": "weight", "bias": "bias"}


def vit_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's :class:`ViT` from the flax model's
    ``params``: ``block_i`` becomes ``blocks.i``; the LayerNorms' scale and
    bias become weight and bias; the ``DenseGeneral`` q/k/v/o kernels keep
    their [D, H, Dh] / [H, Dh, D] shapes; ``Dense`` kernels are transposed;
    the patchify kernel goes from HWIO to OIHW."""
    out: Dict[str, torch.Tensor] = {}
    for path, key, arr in _leaves(params):
        if path and path[0].startswith("block_"):
            block = f"blocks.{path[0][len('block_'):]}"
            module = _VIT_MODULES[path[1]]
            if module.startswith("w"):
                name = f"{block}.{module}"
            elif module.startswith("ln"):
                name = f"{block}.{module}.{_LN_LEAVES[key]}"
            elif key == "kernel":                       # Dense: (in, out)
                name, arr = f"{block}.{module}.weight", arr.T
            else:
                name = f"{block}.{module}.{key}"
        elif not path:                                  # cls, pos_embed
            name = key
        elif path[0] == "LayerNorm_0":
            name = f"ln_f.{_LN_LEAVES[key]}"
        elif key == "kernel":                           # patchify, head
            name = f"{path[0]}.weight"
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        else:
            name = f"{path[0]}.{key}"
        out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out


def mlp_from_jax(params: Sequence[Mapping]) -> Dict[str, torch.Tensor]:
    """State dict of the port's :class:`MLP` from the reference's
    ``init_mlp`` list of ``{"w": (in, out), "b": (out,)}`` layers: layer i's
    ``w`` transposed is ``layers.i.weight``, its ``b`` ``layers.i.bias``."""
    out: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(params):
        out[f"layers.{i}.weight"] = torch.tensor(
            np.ascontiguousarray(np.asarray(layer["w"], dtype=np.float32).T))
        out[f"layers.{i}.bias"] = torch.tensor(
            np.asarray(layer["b"], dtype=np.float32))
    return out
