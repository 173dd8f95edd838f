"""Meshes of ranks, sharding helpers and the data-parallel training steps.

Counterpart of ``piml_tpu/parallel/sharding.py``.  JAX places global
arrays on a ``Mesh`` and lets GSPMD insert the collectives; here a mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` of ranks (one process
each), a "sharded" tensor is the rank's own slice of the global one, and
the collectives are written out (``parallel/distributed.py``).

The data-parallel steps keep the JAX contract at their boundary: every
rank passes the same full batch; each rank pads it, keeps its own
channels (rows), computes the loss and its gradients there, sums the
gradients over the ranks and takes the same Adam step, so the parameters
stay identical on every rank.  Every loss term of
``training_rollout_loss`` is a mask-gated sum (piml_tpu/engine/simulator.py
:380-400), so the global loss is the sum of the ranks' losses and its
gradient the sum of theirs: the gradients are summed, not averaged (as
DDP would).  The one term that divides by a count, the collision-head
accuracy, divides by the count over all ranks' channels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch.distributed.device_mesh import DeviceMesh

from piml_tpu_torch.config import PIMLConfig
from piml_tpu_torch.data.views import T_KEYED, ChanneledData
from piml_tpu_torch.models.blocks import RowShard
from piml_tpu_torch.parallel import distributed as pd

__all__ = ["make_mesh", "axis_size", "axis_rank", "axis_group",
           "shard_leading", "replicate", "pad_channels",
           "pad_channels_stacked", "shard_channeled_batch",
           "shard_stacked_channeled", "all_reduce_grads",
           "make_dp_finetune_step", "make_dp_pointwise_step"]

# per-channel fields padded with NaN (the rest of T_KEYED with 0)
_NAN_FIELDS = ("position", "destination")


def make_mesh(n_devices: Union[int, Sequence[int]] = 0,
              axis: Union[str, Sequence[str]] = "dp",
              device: str = "cuda") -> DeviceMesh:
    """A mesh over the process group's ranks: 1-D of ``n_devices`` ranks
    named ``axis`` (0 = the world size), or, with a shape and as many axis
    names, ``(dp, tp)``-style with ranks laid out row-major.  The mesh
    must cover the world.  ``device``: the ranks' device type."""
    import torch.distributed as dist

    shape = (tuple(n_devices) if isinstance(n_devices, (tuple, list))
             else (n_devices or dist.get_world_size(),))
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(names) != len(shape) or math.prod(shape) != dist.get_world_size():
        raise ValueError(f"make_mesh: shape {shape} / axes {names} do not "
                         f"cover the {dist.get_world_size()} ranks")
    ranks = torch.arange(dist.get_world_size()).reshape(shape)
    return DeviceMesh(torch.device(device).type, ranks, mesh_dim_names=names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (JAX's ``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_leading(tree: Any, mesh: DeviceMesh, axis: str = "dp") -> Any:
    """This rank's contiguous slice of every tensor whose leading axis the
    mesh axis divides; scalars and other leaves stay whole."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)

    def take(x):
        if not torch.is_tensor(x) or x.ndim == 0 or x.shape[0] % n:
            return x
        m = x.shape[0] // n
        return x[r * m:(r + 1) * m]

    return _map(take, tree)


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Rank 0's values on every rank of the mesh (which covers the world,
    :func:`make_mesh`): a tensor, a dict or list of tensors (a
    ``state_dict``), or a module, whose parameters and buffers are
    overwritten in place (the module is returned)."""
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                t.copy_(pd.broadcast(t))
        return tree
    return _map(lambda x: pd.broadcast(x) if torch.is_tensor(x) else x, tree)


def _pad_axis(x: torch.Tensor, axis: int, extra: int, value) -> torch.Tensor:
    shape = list(x.shape)
    shape[axis] = extra
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=axis)


def _pad_channel_axis(batch: ChanneledData, axis: int,
                      multiple: int) -> ChanneledData:
    c = batch.ped_features.shape[axis]
    extra = -c % multiple
    if extra == 0:
        return batch
    return dataclasses.replace(batch, **{
        f: _pad_axis(getattr(batch, f), axis, extra,
                     math.nan if f in _NAN_FIELDS else 0)
        for f in T_KEYED})


def pad_channels(batch: ChanneledData, multiple: int) -> ChanneledData:
    """Pad the window-channel axis to a multiple with inert channels (NaN
    positions and destinations, zeros elsewhere, zero masks): every loss
    term is a mask-gated sum, so they add nothing to the loss or the
    gradients."""
    return _pad_channel_axis(batch, 0, multiple)


def pad_channels_stacked(stacked: ChanneledData,
                         multiple: int) -> ChanneledData:
    """:func:`pad_channels` for a stack of window batches (leading axis =
    batches, second = channels): equal to stacking the padded batches."""
    return _pad_channel_axis(stacked, 1, multiple)


def _shard_channel_axis(batch: ChanneledData, axis: int, mesh: DeviceMesh,
                        mesh_axis: str) -> ChanneledData:
    n, r = axis_size(mesh, mesh_axis), axis_rank(mesh, mesh_axis)
    c = batch.ped_features.shape[axis]
    if c % n:
        raise ValueError(f"channel axis {c} must divide the {mesh_axis} "
                         f"axis ({n}): pad it first")
    m = c // n
    # per-scene statics (waypoints, obstacles, dest_num, ...) stay whole
    return dataclasses.replace(batch, **{
        f: getattr(batch, f).narrow(axis, r * m, m) for f in T_KEYED})


def shard_channeled_batch(batch: ChanneledData, mesh: DeviceMesh,
                          axis: str = "dp") -> ChanneledData:
    """This rank's window channels of ``batch``, padded first with inert
    channels (:func:`pad_channels`) so that every rank gets as many."""
    return _shard_channel_axis(pad_channels(batch, axis_size(mesh, axis)),
                               0, mesh, axis)


def shard_stacked_channeled(stacked: ChanneledData, mesh: DeviceMesh,
                            axis: str = "dp") -> ChanneledData:
    """This rank's channels (second axis) of a stack of window batches;
    the channels must already divide the axis
    (:func:`pad_channels_stacked`)."""
    return _shard_channel_axis(stacked, 1, mesh, axis)


def all_reduce_grads(params, group) -> None:
    """Sum every parameter's gradient over ``group``, in one collective.
    Parameters without a gradient (a head outside the loss) keep none, as
    on every rank alike."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = pd.all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _global_seeds(generator: Optional[torch.Generator], channels: int,
                  frames: int, padded: int, rank: int,
                  per_rank: int) -> Optional[torch.Tensor]:
    """This rank's rows of the global ``(C, T)`` dropout seed table: every
    rank draws the whole table from the same generator, as one device
    does, so a channel's masks do not depend on the split; inert channels
    get seed 0."""
    if generator is None:
        return None
    table = torch.randint(0, 2 ** 62, (channels, frames), generator=generator)
    table = _pad_axis(table, 0, padded - channels, 0)
    return table[rank * per_rank:(rank + 1) * per_rank]


def make_dp_finetune_step(cfg: PIMLConfig, model: torch.nn.Module,
                          opt: torch.optim.Optimizer, mesh: DeviceMesh,
                          axis: str = "dp"):
    """Data-parallel finetune step ``step(batch, generator=None) ->
    TrainingRolloutLoss``.

    ``batch``: the full window batch, the same on every rank; this rank
    takes its channels (:func:`shard_channeled_batch`), runs
    ``training_rollout_loss`` and its backward on them, sums the gradients
    over the mesh axis and steps ``opt``.  ``generator``: live dropout, a
    seed table drawn as one device draws it (:func:`_global_seeds`).
    Returns the global loss terms, summed over the ranks (the same on
    every rank)."""
    from piml_tpu_torch.engine.simulator import (TrainingRolloutLoss,
                                                 training_rollout_loss)

    group = axis_group(mesh, axis)
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    # the batch below is this rank's: the remat policy's per-device count
    # is its channel count
    cfg_local = cfg.replace(n_devices=1)

    def total(count: torch.Tensor) -> torch.Tensor:
        return pd.all_reduce(count, group)

    def step(batch: ChanneledData,
             generator: Optional[torch.Generator] = None):
        local = shard_channeled_batch(batch, mesh, axis)
        seeds = _global_seeds(generator, batch.num_channels,
                              batch.num_frames,
                              local.num_channels * n, r, local.num_channels)
        out = training_rollout_loss(model, cfg_local, local, seeds=seeds,
                                    total=total)
        opt.zero_grad(set_to_none=True)
        out.loss.backward()
        all_reduce_grads(list(model.parameters()), group)
        opt.step()
        terms = pd.all_reduce(torch.stack([t.detach() for t in out]), group)
        return TrainingRolloutLoss(*terms.unbind())

    return step


def make_dp_pointwise_step(cfg: PIMLConfig, model: torch.nn.Module,
                           opt: torch.optim.Optimizer, mesh: DeviceMesh,
                           axis: str = "dp"):
    """Data-parallel pointwise step ``step(ped, obs, self_f, labels,
    generator=None) -> loss``: the rows (the same full batch on every
    rank) split over the mesh axis, the loss ``Σ (pred_acc −
    labels[:, 4:6])²`` summed over the ranks, gradients summed, one Adam
    step.  Rows must divide the axis.  ``generator`` makes dropout live:
    given in the same state on every rank, it draws each mask at the whole
    batch's shape and the rank keeps its rows (``blocks.RowShard``), so
    the masks are one device's, as JAX draws one global mask."""
    group = axis_group(mesh, axis)
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)

    def step(ped, obs, self_f, labels,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if ped.shape[0] % n:
            raise ValueError(f"{ped.shape[0]} rows do not divide the "
                             f"{axis} axis ({n})")
        rows = ped.shape[0]
        ped, obs, self_f, labels = shard_leading(
            (ped, obs, self_f, labels), mesh, axis)
        rng = (None if generator is None
               else RowShard(generator, rows, r * (rows // n)))
        out = model(ped, obs, self_f, rng)
        loss = ((out.pred_acc - labels[:, 4:6]) ** 2).sum()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(list(model.parameters()), group)
        opt.step()
        return pd.all_reduce(loss.detach(), group)

    return step
