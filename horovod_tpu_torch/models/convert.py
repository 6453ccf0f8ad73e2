"""Carry the JAX package's ResNet weights into the port.

``resnet_from_flax(variables)`` turns the ``{"params", "batch_stats"}`` trees
of ``horovod_tpu.models.resnet.ResNet`` (leaves as numpy arrays, or anything
``numpy.asarray`` takes) into a ``state_dict`` for
:class:`horovod_tpu_torch.models.resnet.ResNet` of the same configuration:

- conv kernels go from HWIO to OIHW, the Dense kernel is transposed;
- ``FusedBatchNorm_k``/``BatchNorm_k`` (and ``norm_proj``, ``bn_init``) scale,
  bias, mean and var become weight, bias, running_mean and running_var;
- ``BottleneckBlock_i`` becomes ``blocks.i``, ``Conv_k`` ``conv{k}``,
  ``Dense_0`` ``fc``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

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
