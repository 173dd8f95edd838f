"""Shared NN building blocks (reference: src/models/model.py:16-119).

Counterpart of ``piml_tpu/models/blocks.py``.  Sub-modules carry the flax
module names (``dense_0``, ``block_0``, ``MLP_0``), so a flax parameter path
``a/b/dense_0/kernel`` is the ``state_dict`` key ``a.b.dense_0.weight``
(see ``models/convert.py``).

``ResDNN(chain=False)`` reproduces the reference quirk that each block
reads the original input, so only the last block's output survives
(model.py:115-119): it builds that one block only.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn
from torch.nn import functional as F


def activation_fn(name: str, negative_slope: float = 0.1) -> Callable:
    """str → activation (reference: model.py:16-37)."""
    name = name.lower()
    if name == "sigmoid":
        return torch.sigmoid
    if name == "relu":
        return F.relu
    if name == "leaky_relu":
        return lambda x: F.leaky_relu(x, negative_slope)
    raise NotImplementedError(name)


def _identity(x):
    return x


class MLP(nn.Module):
    """Dense stack: ``activation`` between layers, ``output_act`` on the
    last (reference: model.py:40-65; default output is the identity)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 activation: Callable = F.relu,
                 output_act: Callable = _identity):
        super().__init__()
        self.activation = activation
        self.output_act = output_act
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", nn.Linear(in_features, f))
            in_features = f
        self.out_features = in_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            x = self.activation(x) if i < self.n - 1 else self.output_act(x)
        return x


class ResBlock(nn.Module):
    """``x + act(MLP(x))`` (reference: model.py:68-79)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 activation: Callable = F.relu):
        super().__init__()
        self.MLP_0 = MLP(in_features, features, activation, activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.MLP_0(x)


class ResDNN(nn.Module):
    """Residual MLP processor (reference: model.py:82-119); dropout on the
    output, live only in ``train()`` mode."""

    def __init__(self, in_features: int,
                 hidden_units: Sequence[Sequence[int]],
                 activation: Callable = F.relu, dropout: float = 0.0,
                 chain: bool = False):
        super().__init__()
        self.chain = chain
        blocks = hidden_units if chain else hidden_units[-1:]
        self.n = len(blocks)
        for i, h in enumerate(blocks):
            self.add_module(f"block_{i}", ResBlock(in_features, h, activation))
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for i in range(self.n):
            out = getattr(self, f"block_{i}")(out if self.chain else x)
        if self.dropout is not None:
            out = self.dropout(out)
        return out
