"""Tensor parallelism for wide models (the Megatron layout).

Counterpart of ``piml_tpu/parallel/tensor_parallel.py``.  The JAX package
places a ``PartitionSpec`` on every parameter and lets GSPMD insert the
collectives; here the same rule (:func:`tp_param_spec`) decides which
layers split, and each split ``dense_<i>`` layer of an ``MLP`` becomes a
:class:`TPLinear` that holds its rank's shard and runs its own
collectives, each an autograd function:

- even layers are column-parallel: the output features split over the
  ``tp`` ranks (weight rows and bias); the replicated input passes
  unchanged and its gradient is summed over the ranks;
- odd layers are row-parallel: the input features split; the partial
  products are summed over the ranks (their gradient passes unchanged)
  and the replicated bias is added after the sum;
- a dimension that ``tp`` does not divide stays replicated (the 2-wide
  predictor heads).

Within an MLP the alternation lines up: an odd layer's input width is the
even layer's output width before it, so either both split (one sum per
pair) or neither does.  The output of a column-parallel layer that ends
its MLP is gathered.  The rule is keyed on the flax names of
``models/convert.py`` (``a/b/dense_0/kernel`` is ``a.b.dense_0.weight``),
so one rule reads the flax tree and the ``state_dict``.
"""

from __future__ import annotations

import copy
import re
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.nn import functional as F

from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.models.blocks import MLP
from piml_tpu_torch.parallel import distributed as pd
from piml_tpu_torch.parallel.sharding import (axis_group, axis_rank,
                                              axis_size,
                                              make_dp_finetune_step)

__all__ = ["tp_param_spec", "tp_param_specs", "tp_param_shardings",
           "shard_params_tp", "gather_params_tp", "make_tp_apply",
           "make_tp_dp_finetune_step", "TPLinear"]

_DENSE_RE = re.compile(r"^dense_(\d+)$")
Spec = Tuple[Optional[str], ...]


def tp_param_spec(keys: Sequence[str], shape: Sequence[int],
                  tp: int) -> Spec:
    """The partition of one parameter, in flax's orientation (a kernel is
    ``(in, out)``): the innermost ``dense_<i>`` of ``keys`` decides the
    parity, even → column-parallel ``(None, "tp")`` with bias
    ``("tp",)``, odd → row-parallel ``("tp", None)`` with a replicated
    bias; ``()`` = replicated, also for any dimension ``tp`` does not
    divide (piml_tpu/parallel/tensor_parallel.py ``tp_param_spec``)."""
    dense_idx = None
    for k in keys:
        m = _DENSE_RE.match(k)
        if m:
            dense_idx = int(m.group(1))
    if dense_idx is None or len(shape) == 0:
        return ()
    name = keys[-1]
    col = dense_idx % 2 == 0
    if name == "kernel" and len(shape) == 2:
        if col and shape[1] % tp == 0:
            return (None, "tp")
        if not col and shape[0] % tp == 0:
            return ("tp", None)
    elif name == "bias" and len(shape) == 1 and col and shape[0] % tp == 0:
        return ("tp",)
    return ()


def _flax_keys(name: str) -> Tuple[str, ...]:
    """``a.b.dense_0.weight`` → ``("a", "b", "dense_0", "kernel")``."""
    *mods, leaf = name.split(".")
    return tuple(mods) + ({"weight": "kernel"}.get(leaf, leaf),)


def tp_param_specs(params: Union[nn.Module, Dict[str, torch.Tensor]],
                   tp: int, axis: str = "tp") -> Dict[str, Spec]:
    """Every parameter's partition over ``tp`` ranks, in torch's
    orientation (a ``Linear`` weight is ``(out, in)``, so a column-parallel
    weight is ``(axis, None)``), named ``axis``."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    specs = {}
    for name, t in params.items():
        keys = _flax_keys(name)
        shape = tuple(t.shape)
        flax_shape = shape[::-1] if keys[-1] == "kernel" else shape
        spec = tp_param_spec(keys, flax_shape, tp)
        if keys[-1] == "kernel":
            spec = spec[::-1]
        specs[name] = tuple(axis if s == "tp" else s for s in spec)
    return specs


def tp_param_shardings(params, mesh: DeviceMesh,
                       axis: str = "tp") -> Dict[str, Spec]:
    """:func:`tp_param_specs` over the mesh's ``axis`` (every other mesh
    axis replicates)."""
    return tp_param_specs(params, axis_size(mesh, axis), axis)


# ---------------------------------------------------------------------------
# collectives with their gradients
# ---------------------------------------------------------------------------

class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the group (a replicated
    input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return pd.all_reduce(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Sum over the group forward; identity gradient (the partial
    products of a row-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        return pd.all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    """Concatenate the ranks' last-axis shards; the gradient's own slice
    back (a column-parallel layer that ends its MLP)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        full = pd.all_gather(x.movedim(-1, 0).contiguous(), group)
        return full.movedim(0, -1)

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        return grad[..., r * ctx.width:(r + 1) * ctx.width], None


class TPLinear(nn.Module):
    """One rank's shard of a ``dense_<i>`` layer.  ``models.blocks.dense``
    keeps its dtype rules and calls :meth:`linear` for the product."""

    def __init__(self, layer: nn.Linear, mode: str, group, rank: int,
                 size: int, gather_output: bool):
        super().__init__()
        w, b = layer.weight.detach(), layer.bias.detach()
        if mode == "col":
            o = w.shape[0] // size
            w, b = w[rank * o:(rank + 1) * o], b[rank * o:(rank + 1) * o]
        elif mode == "row":
            i = w.shape[1] // size
            w = w[:, rank * i:(rank + 1) * i]
        self.weight = nn.Parameter(w.clone())
        self.bias = nn.Parameter(b.clone())
        self.mode, self.group = mode, group
        self.gather_output = gather_output

    def linear(self, x, weight, bias):
        if self.mode == "col":
            y = F.linear(_CopyToTP.apply(x, self.group), weight, bias)
            return (_GatherFromTP.apply(y, self.group) if self.gather_output
                    else y)
        return _ReduceFromTP.apply(F.linear(x, weight), self.group) + bias


def shard_params_tp(model: nn.Module, mesh: DeviceMesh, axis: str = "tp"
                    ) -> Tuple[nn.Module, Dict[str, Spec]]:
    """A copy of ``model`` whose split layers hold this rank's shards
    (:class:`TPLinear`), and the specs (:func:`tp_param_shardings`).
    Parameter names are unchanged; the split ones have their shard's
    shape.  Every rank must pass the same weights."""
    specs = tp_param_shardings(model, mesh, axis)
    group = axis_group(mesh, axis)
    rank, size = axis_rank(mesh, axis), axis_size(mesh, axis)
    tp_model = copy.deepcopy(model)
    for mod_name, mlp in list(tp_model.named_modules()):
        if not isinstance(mlp, MLP):
            continue
        for i in range(mlp.n):
            prefix = f"{mod_name}.dense_{i}" if mod_name else f"dense_{i}"
            spec = specs[prefix + ".weight"]
            mode = ("col" if spec == (axis, None)
                    else "row" if spec == (None, axis) else None)
            if mode is not None:
                setattr(mlp, f"dense_{i}", TPLinear(
                    getattr(mlp, f"dense_{i}"), mode, group, rank, size,
                    gather_output=i == mlp.n - 1))
    return tp_model, specs


def gather_params_tp(tp_model: nn.Module) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` of a tensor-parallel model, on every rank
    (each split parameter all-gathered over its layer's group)."""
    full = {}
    for name, t in tp_model.state_dict().items():
        mod_name = name.rsplit(".", 1)[0]
        layer = tp_model.get_submodule(mod_name)
        t = t.detach()
        if isinstance(layer, TPLinear) and layer.mode == "col":
            t = pd.all_gather(t, layer.group)
        elif (isinstance(layer, TPLinear) and layer.mode == "row"
              and name.endswith(".weight")):
            t = pd.all_gather(t.T.contiguous(), layer.group).T
        full[name] = t.contiguous()
    return full


def make_tp_apply(model: nn.Module, mesh: DeviceMesh,
                  axis: str = "tp") -> nn.Module:
    """Tensor-sharded inference: the model from :func:`shard_params_tp`,
    called like ``model`` on replicated inputs, with a replicated output.
    (The JAX function returns ``(apply_jit, sharded_params)``; the module
    holds both.)"""
    return shard_params_tp(model, mesh, axis)[0]


def make_tp_dp_finetune_step(cfg: PIMLConfig, tp_model: nn.Module,
                             opt: torch.optim.Optimizer, mesh: DeviceMesh,
                             dp_axis: str = "dp"):
    """Finetune step over a 2-D ``("dp", "tp")`` mesh: the window channels
    split over ``dp`` (:func:`~piml_tpu_torch.parallel.sharding.make_dp_finetune_step`),
    the parameters over ``tp`` (``tp_model`` from :func:`shard_params_tp`,
    ``opt`` over its parameters: Adam is elementwise, so each rank updates
    its shard as one device would).  The gradients are summed over ``dp``;
    the ``tp`` collectives run inside the model."""
    return make_dp_finetune_step(cfg, tp_model, opt, mesh, dp_axis)
