"""Process groups: start-up, a launcher for ranks on one host, and the
collectives the parallel layer uses.

Counterpart of ``piml_tpu/parallel/distributed.py``.  JAX runs one
process per host that sees every local chip; ``torch.distributed`` runs
one process per rank, each on its own device (``cuda:LOCAL_RANK``, or the
CPU when the caller asks for it).  :func:`init_distributed` joins the
process group that ``torchrun`` describes in the environment;
:func:`spawn_local` starts the ranks of one host itself (the tests, and
``chip_smoke.py``'s four ranks on one card).

The backend is the caller's choice and is never switched behind its back:
``"nccl"`` when each rank has its own GPU, ``"gloo"`` on the CPU and for
several ranks that share one card (NCCL refuses two ranks on one device,
so :func:`spawn_local` raises there).  The collective helpers copy a CUDA
tensor through host memory when the group is gloo's: gloo's collectives
are host-side, and not every one takes a CUDA tensor.  The compute stays
on the card.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "is_multi_host", "spawn_local",
           "all_gather", "all_reduce", "broadcast"]

# how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=600)


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> bool:
    """Join the default process group from the arguments or torchrun's
    variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``, read by the ``env://`` init method).  Returns True if
    a group of several processes is up (or already was), False for the
    single-process no-op.

    ``backend`` defaults to ``"nccl"`` when CUDA is available, else
    ``"gloo"``; with NCCL the process's current device becomes
    ``cuda:LOCAL_RANK``."""
    if dist.is_initialized():
        return True
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if not world_size or world_size <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=TIMEOUT)
    return True


def is_multi_host() -> bool:
    """Whether the group spans more than one host (torchrun's
    ``LOCAL_WORLD_SIZE`` below the world size)."""
    if not dist.is_initialized():
        return False
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    return dist.get_world_size() > local


# ---------------------------------------------------------------------------
# collectives over a group (default: the world)
# ---------------------------------------------------------------------------

def _host_copy(x: torch.Tensor, group) -> bool:
    """gloo's collectives run on the host: a CUDA tensor goes through host
    memory (the compute around it stays on the card)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along axis 0, in
    group-rank order: JAX's ``all_gather(..., tiled=True)``."""
    src = x.detach().cpu() if _host_copy(x, group) else x.detach()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.cat(parts).to(x.device)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x``, as a new tensor: JAX's ``psum``."""
    buf = (x.detach().cpu() if _host_copy(x, group)
           else x.detach().clone()).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.device)


def broadcast(x: torch.Tensor, group=None) -> torch.Tensor:
    """Group rank 0's ``x`` on every rank, as a new tensor."""
    buf = (x.detach().cpu() if _host_copy(x, group)
           else x.detach().clone()).contiguous()
    src = dist.get_global_rank(group, 0) if group is not None else 0
    dist.broadcast(buf, src=src, group=group)
    return buf.to(x.device)


# ---------------------------------------------------------------------------
# ranks on one host
# ---------------------------------------------------------------------------

def _rank_devices(world_size: int, backend: str,
                  device: str) -> List[torch.device]:
    """Each rank's device: ``"cpu"``; ``"cuda"`` → ``cuda:rank`` (a card
    each); ``"cuda:i"`` → that one card, shared by every rank."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("spawn_local: NCCL needs CUDA devices; use "
                             "backend='gloo' on the CPU")
        return [dev] * world_size
    if dev.index is None:
        if world_size > torch.cuda.device_count():
            raise ValueError(
                f"spawn_local: {world_size} ranks, one card each, but "
                f"{torch.cuda.device_count()} cards; name one card "
                f"(device='cuda:0') with backend='gloo' to share it")
        return [torch.device("cuda", r) for r in range(world_size)]
    if backend == "nccl" and world_size > 1:
        raise ValueError(
            f"spawn_local: NCCL refuses several ranks on one device "
            f"({device}); use backend='gloo' to share a card")
    return [dev] * world_size


def _rank_main(rank: int, world_size: int, backend: str, tmp: str,
               devices: Sequence[torch.device], fn: Callable,
               args: Sequence[Any]) -> None:
    torch.set_num_threads(1)
    device = devices[rank]
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world_size)
    if device.type == "cuda":
        os.environ["LOCAL_RANK"] = str(device.index)
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        rank=rank, world_size=world_size, timeout=TIMEOUT)
    try:
        out = fn(rank, device, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_local(fn: Callable, world_size: int, backend: str = "gloo",
                device: str = "cpu", args: Sequence[Any] = (),
                timeout: float = 900.0) -> List[Any]:
    """Run ``fn(rank, device, *args)`` in ``world_size`` fresh processes
    that form one process group; returns the ranks' results in rank order,
    or raises with the first failing rank's traceback
    (``torch.multiprocessing``'s ``ProcessRaisedException``).

    ``fn`` must be importable by name from a module that the ranks can
    import (a spawned process starts from a fresh interpreter).  The group
    meets through a ``file://`` init method in a temporary directory, not a
    TCP port, so concurrent launches never collide; each rank's result
    comes back pickled in a file there.  Each rank runs one intra-op
    thread.  Every process is joined, or killed after ``timeout``
    seconds."""
    import torch.multiprocessing as mp

    devices = _rank_devices(world_size, backend, device)
    with tempfile.TemporaryDirectory(prefix="piml_dist_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(world_size, backend, tmp, devices, fn,
                              tuple(args)),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"spawn_local: no result in "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
