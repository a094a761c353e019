"""Process-group bring-up and host-side collectives.

Counterpart of :mod:`tpudist.distributed`. The ``env://`` contract is the
reference's: ``MASTER_ADDR``/``MASTER_PORT`` (the rendezvous), ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``, as ``torchrun`` exports them. One
process drives one card, ``cuda:LOCAL_RANK``; the group runs NCCL on the
card and gloo on the CPU. ``world_size`` counts ranks, one card each: the
data-parallel degree, which is what the reference's ``jax.device_count()``
means and what the TSV's ``g_step`` multiplies by. With ``WORLD_SIZE`` at
most 1 or unset, the run is single-process and forms no group. A group a
caller has already formed (``torch.distributed.init_process_group``) is
used as it is.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from tpudist_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DistributedContext:
    """The world after bring-up: this process's ``rank`` among
    ``world_size`` ranks, its ``local_rank`` on the host, its ``device``."""

    rank: int
    world_size: int
    local_rank: int
    device: torch.device

    @property
    def is_chief(self) -> bool:
        return self.rank == 0


def group_up() -> bool:
    """A process group is formed."""
    return dist.is_available() and dist.is_initialized()


def init_from_env(device=None) -> DistributedContext:
    """Form the world from the ``env://`` contract (module docstring).
    ``device``: ``None`` for the card (raises without one), ``"cpu"`` for
    the CPU."""
    dev = resolve_device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if not group_up() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    if group_up():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    return DistributedContext(rank=rank, world_size=world,
                              local_rank=local_rank, device=dev)


def reduce_loss(value: float) -> float:
    """Global mean of a per-process scalar on every rank (the reference's
    ``reduce_loss``); the value itself without a group."""
    if not group_up():
        return float(value)
    backend = dist.get_backend()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if backend == "nccl" else torch.device("cpu"))
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    dist.all_reduce(t)
    return float(t) / dist.get_world_size()


def barrier() -> None:
    """Cross-process barrier; a no-op without a group."""
    if group_up():
        dist.barrier()
