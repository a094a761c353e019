"""Fully-sharded data parallelism over the ``fsdp`` axis, with FSDP2.

Counterpart of :mod:`tpudist.parallel.fsdp`. The reference's FSDP is a
sharding: every leaf is split over ``fsdp`` on its largest divisible dim
(:func:`fsdp_spec`, the one rule :func:`tpudist_torch.mesh.
largest_divisible_spec`), leaves under ``min_size`` stay replicated, and
GSPMD gathers each layer's parameters before use and reduce-scatters its
gradients. Here FSDP2's ``fully_shard`` does that work
(:func:`apply_fsdp`): one call on each block (the elements of the model's
block list) and one on the root, ``shard_placement_fn`` returning
``Shard(dim)`` for the spec's dim, the small leaves in ``ignored_params``
(replicated; the train step all-reduces their gradients, which FSDP does
not touch). On a ``data x fsdp`` layout the DeviceMesh is 2-D and FSDP2
runs hybrid: sharded over ``fsdp``, replicated and all-reduced over
``data``; the batch is split over both.

Placements can differ from the reference's on ties: flax stores a dense
kernel ``[in, out]``, the port ``[out, in]``, and the rule takes the last
of equal dims. Per-device bytes are the same.

The fused AdamW under FSDP runs its kernel over the local shards: FSDP's
sharded float32 parameters are the masters, and the bf16 compute copy is
FSDP2's ``MixedPrecisionPolicy(param_dtype=bf16)`` cast at the
all-gather, which rounds the new master as the kernel's own ``(p +
u).to(bf16)`` does.

FSDP composed with tensor parallelism (:func:`compose_fsdp`, the
reference's rule, ``tpudist.parallel.plan._leaf_sharding``): a leaf the
tensor axis places (the family's ``tensor_specs``) keeps that placement
and is not sharded over fsdp (it joins ``ignored_params``); every other
leaf takes the fsdp rule. FSDP2 runs over the ranks with this rank's
tensor index (:meth:`tpudist_torch.mesh.RankLayout.fsdp_mesh`: ``(data,
fsdp)`` or ``fsdp``), never over the tensor group. The gradients of
every ignored leaf (the tensor shards and the small replicated leaves)
are averaged by the train step over the same ranks
(:attr:`~tpudist_torch.mesh.RankLayout.batch_group`). Sharding the
tensor shards over fsdp as well would hold fewer bytes; the reference
does not place them so, and neither does the port.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tpudist_torch.mesh import FSDP_AXIS, largest_divisible_dim, \
    largest_divisible_spec


def fsdp_spec(shape, fsdp_size: int, *, min_size: int = 1024) -> tuple:
    """The spec sharding the largest ``fsdp``-divisible dim of ``shape``
    (``()``: replicated)."""
    return largest_divisible_spec(tuple(shape), FSDP_AXIS, fsdp_size,
                                  min_size=min_size)


def blocks_of(model: nn.Module) -> list[nn.Module]:
    """The model's blocks: the elements of its direct ``ModuleList``
    children (GPT-2's ``h``, the others' ``blocks``)."""
    return [b for child in model.children() if isinstance(child, nn.ModuleList)
            for b in child]


def _base_optimizer(tx):
    while hasattr(tx, "inner"):
        tx = tx.inner
    return tx


def apply_fsdp(model: nn.Module, layout, tx=None, *,
               min_size: int = 1024) -> dict:
    """Shard ``model`` in place over ``layout``'s fsdp axis (module
    docstring) and tell ``tx`` (its innermost optimizer) which gradients
    are shards of the fsdp group. Under a fused optimizer with a compute
    copy the gathered parameters are cast to the copy's dtype. Over a
    group of one rank every dim divides: each leaf of ``min_size``
    elements or more is a (whole) shard on its largest dim, so one card
    runs FSDP2's gathers, casts and reductions for real. A model on a
    layout with a tensor axis keeps its tensor shards whole on the rank
    (:func:`compose_fsdp`). Returns ``{name: shard dim or None}``."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor import Shard

    from tpudist_torch.parallel import tp as tp_lib

    placed = set(tp_lib.sharded_names(model))

    def dim(name, shape):
        if name in placed:
            return None
        if layout.fsdp > 1:
            return largest_divisible_dim(shape, layout.fsdp,
                                         min_size=min_size)
        if not shape or math.prod(shape) < min_size:
            return None
        return max((d, i) for i, d in enumerate(shape))[1]

    dims = {k: dim(k, tuple(p.shape)) for k, p in model.named_parameters()}
    for k, p in model.named_parameters():
        if dims[k] is not None and not p.is_contiguous():
            # FSDP2 shards contiguous parameters only (a ResNet's
            # channels-last conv weights on the card are not)
            p.data = p.data.contiguous()
    ignored = {p for k, p in model.named_parameters() if dims[k] is None}
    by_param = {p: dims[k] for k, p in model.named_parameters()}

    def place(p):
        return Shard(by_param[p])

    copy = getattr(tx, "compute_dtype", None) if tx is not None else None
    mesh = layout.fsdp_mesh() if layout.fsdp > 1 else layout.device_mesh
    kw = dict(mesh=mesh, shard_placement_fn=place,
              ignored_params=ignored)
    if copy is not None:
        kw["mp_policy"] = MixedPrecisionPolicy(param_dtype=copy,
                                               reduce_dtype=torch.float32)
    for block in blocks_of(model):
        fully_shard(block, **kw)
    fully_shard(model, **kw)
    if tx is not None:
        _base_optimizer(tx).shard_over(
            layout.fsdp_group, [k for k, d in dims.items() if d is not None])
    return dims


#: the reference's name for FSDP over a state that already holds
#: model-parallel placements (``tpudist.parallel.fsdp.compose_fsdp``):
#: :func:`apply_fsdp` keeps the tensor placements of a model on a tensor
#: layout and shards the rest
compose_fsdp = apply_fsdp
