"""Minimal MLP classifier, the framework's MNIST example model.

The port's counterpart of ``horovod_tpu/models/mlp.py``: ReLU hidden layers
and a linear head, each layer's weight drawn from N(0, 2 / fan_in) and its
bias zero. It has no kernel; the multi-rank optimizer tests train it.
``models/convert.py:mlp_from_jax`` carries the JAX package's parameter list
over.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class MLP(nn.Module):
    """``sizes`` = (inputs, hidden..., classes); ``layers.i`` is the i-th
    ``nn.Linear`` (weight (out, in), the transpose of the reference's
    ``w``)."""

    def __init__(self, sizes: Sequence[int] = (784, 256, 128, 10),
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.layers = nn.ModuleList()
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            layer = nn.Linear(fan_in, fan_out, dtype=dtype)
            with torch.no_grad():
                layer.weight.copy_(torch.randn(fan_out, fan_in,
                                               generator=generator)
                                   * (2.0 / fan_in) ** 0.5)
                layer.bias.zero_()
            self.layers.append(layer)

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


def softmax_cross_entropy(logits, labels):
    """Mean over the batch of −log softmax(logits)[label]."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def mlp_loss(model: MLP, batch):
    x, y = batch
    return softmax_cross_entropy(model(x), y)
