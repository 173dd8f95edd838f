"""Shared NN building blocks (reference: src/models/model.py:16-119).

Counterpart of ``piml_tpu/models/blocks.py``.  Sub-modules carry the flax
module names (``dense_0``, ``block_0``, ``MLP_0``), so a flax parameter path
``a/b/dense_0/kernel`` is the ``state_dict`` key ``a.b.dense_0.weight``
(see ``models/convert.py``).

``dtype`` is flax's ``nn.Dense(dtype=...)``: the parameters stay float32;
a layer with a dtype casts its input, weight and bias to it and returns
that dtype; a layer without one computes in the promoted dtype of its
input and parameters (flax's ``promote_dtype``), so a bfloat16 input
meeting float32 parameters computes in float32.  The elementwise ops
between layers (activations, the residual add, sums, dropout) run in
the dtype their operands carry, as in JAX.  ``torch.autocast`` would
choose otherwise, so it is not used.

``ResDNN(chain=False)`` reproduces the reference quirk that each block
reads the original input, so only the last block's output survives
(model.py:115-119): it builds that one block only.

Dropout is live only when a forward is given random generators (the JAX
package's ``deterministic=False`` with a dropout key): one for a batch of
pretrain rows, or one per slice of the input's leading axis (the window
channels of the finetune).  Its masks
come from those ``torch.Generator``s, never from the global RNG, so a
frame that activation checkpointing recomputes draws the same masks
again.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

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


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``layer`` applied with flax ``nn.Dense`` dtype semantics (above).
    A tensor-parallel shard (``parallel/tensor_parallel.py``) brings its
    own product, with its collectives."""
    dt = dtype or torch.promote_types(x.dtype, layer.weight.dtype)
    linear = getattr(layer, "linear", F.linear)
    return linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))


class MLP(nn.Module):
    """Dense stack: ``activation`` between layers, ``output_act`` on the
    last (reference: model.py:40-65; default output is the identity);
    ``dtype``: the layers' compute dtype."""

    def __init__(self, in_features: int, features: Sequence[int],
                 activation: Callable = F.relu,
                 output_act: Callable = _identity,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.activation = activation
        self.output_act = output_act
        self.dtype = dtype
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", nn.Linear(in_features, f))
            in_features = f
        self.out_features = in_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = dense(getattr(self, f"dense_{i}"), x, self.dtype)
            x = self.activation(x) if i < self.n - 1 else self.output_act(x)
        return x


class ResBlock(nn.Module):
    """``x + act(MLP(x))`` (reference: model.py:68-79)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 activation: Callable = F.relu,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.MLP_0 = MLP(in_features, features, activation, activation,
                         dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.MLP_0(x)


class RowShard:
    """Dropout for one shard of a row batch: each mask is drawn at the
    whole batch's shape, ``(rows, ...)``, from ``generator`` (in the same
    state on every shard), and the shard keeps its rows ``start`` onwards,
    so its masks are the rows of one device's."""

    def __init__(self, generator: torch.Generator, rows: int, start: int):
        self.generator, self.rows, self.start = generator, rows, start


Rng = Optional[Union[torch.Generator, RowShard, Sequence[torch.Generator]]]


def dropout(x: torch.Tensor, p: float, rng: Rng) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep with probability
    ``1 − p`` and scale by ``1 / (1 − p)``.  ``rng``: one generator for
    the whole tensor (the pretrain's row batches), a :class:`RowShard` of
    it, or one per slice of the leading axis, each slice's mask from its
    own stream; None = identity."""
    if rng is None or p <= 0:
        return x
    if isinstance(rng, RowShard):
        keep = torch.bernoulli(
            torch.full((rng.rows,) + x.shape[1:], 1.0 - p, device=x.device),
            generator=rng.generator).narrow(0, rng.start, x.shape[0])
        return torch.where(keep > 0, x / (1.0 - p), 0.0)
    if isinstance(rng, torch.Generator):
        keep = torch.bernoulli(torch.full(x.shape, 1.0 - p, device=x.device),
                               generator=rng)
        return torch.where(keep > 0, x / (1.0 - p), 0.0)
    if len(rng) != x.shape[0]:
        raise ValueError(f"dropout: {len(rng)} generators for a leading "
                         f"axis of {x.shape[0]}")
    keep_p = torch.full(x.shape[1:], 1.0 - p, device=x.device)
    keep = torch.stack([torch.bernoulli(keep_p, generator=g) for g in rng])
    return torch.where(keep > 0, x / (1.0 - p), 0.0)


class ResDNN(nn.Module):
    """Residual MLP processor (reference: model.py:82-119); dropout on the
    output, live when ``forward`` is given generators."""

    def __init__(self, in_features: int,
                 hidden_units: Sequence[Sequence[int]],
                 activation: Callable = F.relu, dropout: float = 0.0,
                 chain: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.chain = chain
        blocks = hidden_units if chain else hidden_units[-1:]
        self.n = len(blocks)
        for i, h in enumerate(blocks):
            self.add_module(f"block_{i}",
                            ResBlock(in_features, h, activation, dtype))
        self.p = dropout

    def forward(self, x: torch.Tensor, rng: Rng = None) -> torch.Tensor:
        out = x
        for i in range(self.n):
            out = getattr(self, f"block_{i}")(out if self.chain else x)
        return dropout(out, self.p, rng)


class AttnPooling(nn.Module):
    """Softmax-of-exp attention pooling over the neighbour axis
    (reference: model.py:950-970): weights ``softmax(exp(MLP(x)))`` over
    the k axis, ``(..., k, d) → (..., d)``."""

    def __init__(self, in_features: int, dim: int):
        super().__init__()
        self.MLP_0 = MLP(in_features, (dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = torch.softmax(torch.exp(self.MLP_0(x)), dim=-2)  # ..., k, 1
        return (x * attn).sum(dim=-2)
