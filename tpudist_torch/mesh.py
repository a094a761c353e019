"""The data x fsdp x pipe x expert x seq x tensor rank layout: the part
of :mod:`tpudist.mesh` that data, fully-sharded, pipeline, expert,
context and tensor parallelism need.

The reference lays its devices out as a named mesh whose axis order is
``data, fsdp, pipe, expert, seq, tensor``. Rank ``r`` of a world of
``data * fsdp * pipe * expert * seq * tensor`` ranks sits at
``tensor_idx = r % tensor``, ``seq_idx = (r // tensor) % seq``,
``expert_idx = (r // (seq * tensor)) % expert``, ``pipe_idx = (r //
(expert * seq * tensor)) % pipe``, ``fsdp_idx = (r // (pipe * expert *
seq * tensor)) % fsdp`` and ``data_idx = r // (fsdp * pipe * expert *
seq * tensor)``: the reference's device order, tensor innermost.
:func:`create_layout` gives a rank those coordinates and its process
groups, created on every rank in the same order: its tensor peers (the
Megatron layers of :mod:`tpudist_torch.parallel.tp` all-reduce over
them), its seq peers (ring and Ulysses attention run over them), its
expert peers (the MoE layers of :mod:`tpudist_torch.parallel.ep` gather
their slot outputs over them), its pipe peers (the stages of
:mod:`tpudist_torch.parallel.pp`, which pass activations along them),
its fsdp peers (FSDP shards parameters over them) and its data replicas
(the ranks with its fsdp, pipe, expert, seq and tensor coordinates; DDP,
the explicit reducer and ZeRO-1 work over them). The batch is split over
``data x fsdp`` jointly (:attr:`RankLayout.replica`), as the reference's
``batch_sharding`` splits it; the pipe, expert, tensor and seq ranks of a
replica share its batch (tokens are replicated over expert). A rank's
batch peers (:attr:`RankLayout.batch_group`) are the ranks with its
pipe, expert and tensor indices: its data, fsdp and seq peers together,
over which the gradients of what the pipe, expert and tensor axes hold in
parts are averaged. ``fsdp`` with ``seq > 1`` is refused, as the
reference's ``train_gpt2.py`` refuses it; ``tensor`` composes with
either, ``pipe`` with data and tensor, ``expert`` with data and tensor.
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
        if self.fsdp > 1 and self.seq > 1:
            raise ValueError(
                "fsdp does not compose with seq > 1 (the context-parallel "
                "step keeps parameters replicated), as the reference's "
                "train_gpt2.py refuses --fsdp with --cp")

    def axis_sizes(self, world: int) -> dict[str, int]:
        """``{"data": ..., "fsdp": ..., "pipe": ..., "expert": ...,
        "seq": ..., "tensor": ...}`` over ``world`` ranks."""
        sizes = {DATA_AXIS: self.data, FSDP_AXIS: self.fsdp,
                 PIPELINE_AXIS: self.pipe, EXPERT_AXIS: self.expert,
                 SEQUENCE_AXIS: self.seq, TENSOR_AXIS: self.tensor}
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
        if sizes[FSDP_AXIS] > 1 and sizes[SEQUENCE_AXIS] > 1:
            raise ValueError(
                "fsdp does not compose with seq > 1 (the context-parallel "
                "step keeps parameters replicated), as the reference's "
                "train_gpt2.py refuses --fsdp with --cp")
        if sizes[PIPELINE_AXIS] > 1 and sizes[SEQUENCE_AXIS] > 1:
            raise NotImplementedError(
                "a pipe axis beside a seq axis is not ported yet (ROADMAP "
                f"{PIPE_REMAINDER}); the port lays out data x pipe x tensor")
        if sizes[EXPERT_AXIS] > 1 and (sizes[FSDP_AXIS] > 1
                                       or sizes[SEQUENCE_AXIS] > 1
                                       or sizes[PIPELINE_AXIS] > 1):
            raise NotImplementedError(
                "an expert axis beside fsdp, seq or pipe is not ported yet "
                f"(ROADMAP {EXPERT_REMAINDER}); the port lays out data x "
                "expert x tensor")
        return sizes


#: the ROADMAP item of the pipe compositions not ported yet
PIPE_REMAINDER = "Queue 1 #7c (remainder)"
#: the ROADMAP item of the expert compositions not ported yet
EXPERT_REMAINDER = "Queue 1 #7d (remainder)"


def largest_divisible_dim(shape, size: int, *,
                          min_size: int = 1024) -> int | None:
    """The dim of ``shape`` to shard ``size`` ways: the largest one
    ``size`` divides (the last of equal ones, as the reference's ``max``
    over ``(dim, index)`` picks), or None when ``size`` is 1, the leaf
    holds fewer than ``min_size`` elements or no dim divides."""
    if size <= 1 or math.prod(shape) < min_size:
        return None
    candidates = [(d, i) for i, d in enumerate(shape) if d % size == 0]
    return max(candidates)[1] if candidates else None


def largest_divisible_spec(shape, axis: str, size: int, *,
                           min_size: int = 1024) -> tuple:
    """The reference's one spec rule (``tpudist.mesh.
    largest_divisible_spec``) as a tuple: ``axis`` at the
    :func:`largest_divisible_dim`, None elsewhere; ``()`` when nothing
    qualifies (the leaf stays replicated)."""
    dim = largest_divisible_dim(shape, size, min_size=min_size)
    if dim is None:
        return ()
    return tuple(axis if i == dim else None for i in range(len(shape)))


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """This rank's place in a ``data x fsdp x pipe x expert x seq x
    tensor`` world. A group is None when its axis is 1 (no collective).
    ``device_mesh`` is the ``torch.distributed`` DeviceMesh over the same
    groups, one dim for each axis above 1 in the order ``data, fsdp, pipe,
    expert, seq, tensor`` (seq
    only beside a tensor axis; None when every axis is 1): FSDP2
    (:meth:`fsdp_mesh`), the ZeRO-1 DTensors (:meth:`data_mesh`) and the
    tensor shards in a checkpoint (:meth:`shard_mesh`) are placed on it.
    ``batch_group``: the ranks with this rank's pipe, expert and tensor
    indices (None: none other). ``pipe_ranks``: the global ranks of this rank's
    pipe group in stage order (None with one stage)."""

    rank: int
    data: int
    seq: int
    seq_group: object = None
    data_group: object = None
    fsdp: int = 1
    fsdp_group: object = None
    device_mesh: object = None
    tensor: int = 1
    tensor_group: object = None
    batch_group: object = None
    pipe: int = 1
    pipe_group: object = None
    pipe_ranks: tuple | None = None
    expert: int = 1
    expert_group: object = None

    @property
    def data_idx(self) -> int:
        return self.rank // (self.fsdp * self.pipe * self.expert * self.seq
                             * self.tensor)

    @property
    def fsdp_idx(self) -> int:
        return (self.rank // (self.pipe * self.expert * self.seq
                              * self.tensor)) % self.fsdp

    @property
    def pipe_idx(self) -> int:
        return (self.rank // (self.expert * self.seq * self.tensor)) % self.pipe

    @property
    def expert_idx(self) -> int:
        return (self.rank // (self.seq * self.tensor)) % self.expert

    @property
    def seq_idx(self) -> int:
        return (self.rank // self.tensor) % self.seq

    @property
    def tensor_idx(self) -> int:
        return self.rank % self.tensor

    @property
    def prev_stage(self) -> int | None:
        """The global rank of the stage before this rank's (None at the
        first stage)."""
        i = self.pipe_idx
        return self.pipe_ranks[i - 1] if i > 0 else None

    @property
    def next_stage(self) -> int | None:
        """The global rank of the stage after this rank's (None at the
        last stage)."""
        i = self.pipe_idx
        return self.pipe_ranks[i + 1] if i < self.pipe - 1 else None

    @property
    def data_parallel_size(self) -> int:
        """Replicas the batch is split over: ``data * fsdp`` (the
        reference's ``data_parallel_size``)."""
        return self.data * self.fsdp

    @property
    def replica(self) -> int:
        """This rank's index among the ``data * fsdp`` batch replicas."""
        return self.data_idx * self.fsdp + self.fsdp_idx

    def _sub_mesh(self, *axes: str):
        """The DeviceMesh of ``axes`` (those above 1), None without one."""
        axes = tuple(a for a in axes if getattr(self, a) > 1)
        if not axes:
            return None
        if self.device_mesh.mesh_dim_names == axes:
            return self.device_mesh
        return self.device_mesh[axes if len(axes) > 1 else axes[0]]

    def data_mesh(self):
        """The 1-D DeviceMesh of this rank's data replicas (None with one
        data replica)."""
        return self._sub_mesh(DATA_AXIS)

    def tensor_mesh(self):
        """The 1-D DeviceMesh of this rank's tensor peers (None with one
        tensor rank)."""
        return self._sub_mesh(TENSOR_AXIS)

    def shard_mesh(self):
        """The DeviceMesh a tensor shard is placed on in a checkpoint: the
        whole mesh without its pipe dim (a stage's leaves live on its own
        ranks alone), the tensor dim last."""
        if self.pipe == 1:
            return self.device_mesh
        return self._sub_mesh(DATA_AXIS, FSDP_AXIS, EXPERT_AXIS,
                              SEQUENCE_AXIS, TENSOR_AXIS)

    def fsdp_mesh(self):
        """The DeviceMesh FSDP2 shards over: ``(data, fsdp)`` (hybrid:
        sharded over fsdp, replicated over data) or ``fsdp``, the ranks
        with this rank's tensor index; None with one fsdp rank."""
        if self.fsdp == 1:
            return None
        return self._sub_mesh(DATA_AXIS, FSDP_AXIS)

    def __deepcopy__(self, memo):
        # process groups are process-wide: a copied model shares them
        return self


def _groups(rank: int, world: int, stride: int, size: int):
    """Create (on every rank, in the same order) the groups of ``size``
    ranks ``stride`` apart; return this rank's."""
    mine = None
    starts = [r for r in range(world) if (r // stride) % size == 0]
    for start in starts:
        ranks = [start + k * stride for k in range(size)]
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def _sharing(rank: int, world: int, key):
    """Create (on every rank, in the same order) the groups of the ranks
    with equal ``key(rank)``; return this rank's."""
    mine = None
    for k in sorted({key(r) for r in range(world)}):
        ranks = [r for r in range(world) if key(r) == k]
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def create_layout(config: MeshConfig = MeshConfig(), *,
                  device_type: str | None = None) -> RankLayout:
    """The layout of this rank in the formed world (one rank without a
    process group). Every rank must call it, in the same order as its
    other group creations. ``device_type`` is the DeviceMesh's (where
    FSDP2 keeps its shards): by default ``cuda`` under NCCL, else ``cpu``;
    ranks that hold CUDA tensors over gloo pass ``cuda``."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    sizes = config.axis_sizes(world)
    data, fsdp, seq = sizes[DATA_AXIS], sizes[FSDP_AXIS], sizes[SEQUENCE_AXIS]
    tensor, pipe = sizes[TENSOR_AXIS], sizes[PIPELINE_AXIS]
    expert = sizes[EXPERT_AXIS]
    seq_group = data_group = fsdp_group = tensor_group = device_mesh = None
    batch_group = pipe_group = pipe_ranks = expert_group = None
    if tensor > 1 and tensor < world:
        tensor_group = _groups(rank, world, 1, tensor)
    elif tensor > 1:
        tensor_group = dist.group.WORLD
    if seq > 1:
        seq_group = _groups(rank, world, tensor, seq)
    if expert > 1:
        expert_group = (_groups(rank, world, seq * tensor, expert)
                        if expert < world else dist.group.WORLD)
    if pipe > 1:
        stride = expert * seq * tensor
        pipe_group = (_groups(rank, world, stride, pipe) if pipe < world
                      else dist.group.WORLD)
        first = rank - ((rank // stride) % pipe) * stride
        pipe_ranks = tuple(first + k * stride for k in range(pipe))
    if fsdp > 1:
        fsdp_group = _groups(rank, world, pipe * expert * seq * tensor, fsdp)
    if data > 1 and data < world:
        data_group = _groups(rank, world,
                             fsdp * pipe * expert * seq * tensor, data)
    elif data > 1:
        data_group = dist.group.WORLD
    if 1 < pipe * expert * tensor < world:
        # the ranks with this rank's (pipe, expert, tensor) indices: data
        # x fsdp x seq
        batch_group = _sharing(rank, world, lambda r: (
            r // (expert * seq * tensor) % pipe,
            r // (seq * tensor) % expert, r % tensor))
    elif pipe * expert * tensor == 1 and world > 1:
        batch_group = dist.group.WORLD
    axes = [(a, n, g) for a, n, g in (
        (DATA_AXIS, data, data_group), (FSDP_AXIS, fsdp, fsdp_group),
        (PIPELINE_AXIS, pipe, pipe_group),
        (EXPERT_AXIS, expert, expert_group),
        (SEQUENCE_AXIS, seq if tensor > 1 else 1, seq_group),
        (TENSOR_AXIS, tensor, tensor_group)) if n > 1]
    if axes:
        import torch
        from torch.distributed.device_mesh import DeviceMesh

        if device_type is None:
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        names = tuple(a for a, _, _ in axes)
        if len(axes) > 1:
            device_mesh = DeviceMesh.from_group(
                [g for _, _, g in axes], device_type,
                mesh=torch.arange(world).view(*(n for _, n, _ in axes)),
                mesh_dim_names=names)
        else:
            device_mesh = DeviceMesh.from_group(axes[0][2], device_type,
                                                mesh_dim_names=names)
    return RankLayout(rank, data, seq, seq_group, data_group, fsdp,
                      fsdp_group, device_mesh, tensor, tensor_group,
                      batch_group, pipe, pipe_group, pipe_ranks, expert,
                      expert_group)
