"""The data x seq rank layout: the part of :mod:`tpudist.mesh` that
context parallelism needs.

The reference lays its devices out as a named mesh whose axis order is
``data, fsdp, pipe, expert, seq, tensor``. With every axis but ``data``
and ``seq`` at 1, ``seq`` is the innermost, so rank ``r`` of a world of
``data * seq`` ranks sits at ``(data_idx, seq_idx) = (r // seq, r %
seq)``: the reference's device order. :func:`create_layout` gives a rank
those coordinates and two process groups, created on every rank in the
same order: its seq peers (its ``data`` index fixed; ring and Ulysses
attention run over them) and its data replicas (its ``seq`` index fixed).
The other axes (fsdp, pipe, expert, tensor) are not ported yet and raise,
naming ROADMAP Queue 1 #7.
"""

from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
PIPELINE_AXIS = "pipe"
TENSOR_AXIS = "tensor"
SEQUENCE_AXIS = "seq"
EXPERT_AXIS = "expert"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical layout; ``-1`` on an axis means "all remaining ranks"."""

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def __post_init__(self):
        for axis in (FSDP_AXIS, PIPELINE_AXIS, EXPERT_AXIS, TENSOR_AXIS):
            if getattr(self, axis) != 1:
                raise NotImplementedError(
                    f"MeshConfig({axis}={getattr(self, axis)}) is not ported "
                    "yet (ROADMAP Queue 1 #7); the port lays out data x seq")

    def axis_sizes(self, world: int) -> dict[str, int]:
        """``{"data": ..., "seq": ...}`` over ``world`` ranks."""
        sizes = {DATA_AXIS: self.data, SEQUENCE_AXIS: self.seq}
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        if any(v == 0 or v < -1 for v in sizes.values()):
            raise ValueError(f"axis sizes must be positive or -1, got {sizes}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if world % fixed:
                raise ValueError(f"{world} ranks not divisible by the fixed "
                                 f"axes' product {fixed} ({sizes})")
            sizes[wild[0]] = world // fixed
        elif fixed != world:
            raise ValueError(f"layout {sizes} wants {fixed} ranks, the world "
                             f"has {world}")
        return sizes


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """This rank's place in a ``data x seq`` world. ``seq_group`` and
    ``data_group`` are None when their axis is 1 (no collective)."""

    rank: int
    data: int
    seq: int
    seq_group: object = None
    data_group: object = None

    @property
    def data_idx(self) -> int:
        return self.rank // self.seq

    @property
    def seq_idx(self) -> int:
        return self.rank % self.seq

    def __deepcopy__(self, memo):
        # process groups are process-wide: a copied model shares them
        return self


def create_layout(config: MeshConfig = MeshConfig()) -> RankLayout:
    """The layout of this rank in the formed world (one rank without a
    process group). Every rank must call it, in the same order as its
    other group creations."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    sizes = config.axis_sizes(world)
    data, seq = sizes[DATA_AXIS], sizes[SEQUENCE_AXIS]
    seq_group = data_group = None
    if seq > 1:
        for d in range(data):
            g = dist.new_group([d * seq + j for j in range(seq)])
            if d == rank // seq:
                seq_group = g
    if data > 1 and seq > 1:
        for j in range(seq):
            g = dist.new_group([d * seq + j for d in range(data)])
            if j == rank % seq:
                data_group = g
    elif data > 1:
        data_group = dist.group.WORLD
    return RankLayout(rank, data, seq, seq_group, data_group)
