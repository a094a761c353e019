"""ParallelPlan: the one resolver for a composed run, over data x fsdp
x tensor, data x seq x tensor, data x pipe x tensor or data x expert x
tensor.

Counterpart of :mod:`tpudist.parallel.plan` for the data-parallel and
tensor axes: a plan holds the rank layout
(:func:`tpudist_torch.mesh.create_layout`), the replicate-below threshold
shared by FSDP and ZeRO-1, and the rules that tie them:

- FSDP shards every leaf over ``fsdp`` on its largest divisible dim
  (:mod:`tpudist_torch.parallel.fsdp`), and the batch rides ``data x
  fsdp`` jointly; a leaf the tensor axis places keeps that placement and
  is not sharded over fsdp (the reference's ``_leaf_sharding``);
- :meth:`ParallelPlan.wrap_zero1` is ZeRO-1 over ``data`` that skips the
  leaves the plan already shards over ``fsdp`` and, beside an fsdp axis,
  those the tensor axis places, so nothing is sharded twice; with more
  than one data replica the state of an fsdp-sharded leaf is sliced again
  over data where its dim divides (the reference's ``_mirror_overlay``);
  without fsdp, a rank slices its own tensor shards;
- a ``tensor`` axis shards the LMs' Megatron layers
  (:mod:`tpudist_torch.parallel.tp`; the model is built on
  :attr:`ParallelPlan.layout`), and the tensor ranks of a replica share
  its batch;
- :meth:`ParallelPlan.validate_reduce` refuses the explicit reducer on a
  plan with a real ``fsdp`` or ``tensor`` axis, with the reference's hint;
- a ``pipe`` axis holds each stage's blocks on its ranks alone
  (:mod:`tpudist_torch.parallel.pp`) and replicates the rest over the
  stages; fsdp and ZeRO-1 beside it raise, naming "Queue 1 #7c
  (remainder)";
- an ``expert`` axis holds ``1 / expert`` of each MoE layer's experts
  on a rank (:mod:`tpudist_torch.parallel.ep`) and replicates the rest
  over the expert ranks; ZeRO-1 keeps the expert leaves' state whole, as
  the reference's ``wrap_zero1`` exempts them, and fsdp or seq beside it
  raise, naming "Queue 1 #7d (remainder)";
- :meth:`ParallelPlan.axis_worlds` is what a checkpoint's geometry
  records (``fsdp_world``, ``tensor_world``, ``pipe_world``,
  ``expert_world``).
"""

from __future__ import annotations

import dataclasses

from tpudist_torch.mesh import (
    EXPERT_AXIS, FSDP_AXIS, PIPE_REMAINDER, PIPELINE_AXIS, TENSOR_AXIS,
    MeshConfig, RankLayout, create_layout, largest_divisible_spec)

__all__ = ["ParallelPlan", "spec_is_sharded"]


def spec_is_sharded(spec, sizes: dict) -> bool:
    """True iff ``spec`` names an axis of more than one rank (``sizes``:
    axis name -> size)."""
    for part in tuple(spec or ()):
        names = part if isinstance(part, tuple) else (part,)
        if any(n is not None and int(sizes.get(n, 1)) > 1 for n in names):
            return True
    return False


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """The resolved composition of one layout; ``fsdp_min_size`` is the
    replicate-below threshold (elements) shared with ZeRO-1."""

    layout: RankLayout
    fsdp_min_size: int = 1024

    @property
    def wraps_fsdp(self) -> bool:
        """The model is wrapped with FSDP under this plan: the layout has
        an fsdp group (one of a single rank, too: one card then runs
        FSDP's gathers, casts and reductions for real)."""
        return self.layout.fsdp_group is not None

    @classmethod
    def build(cls, *, data: int = -1, fsdp: int = 1, pipe: int = 1,
              tensor: int = 1, expert: int = 1, seq: int = 1,
              device_type: str | None = None, **kw) -> "ParallelPlan":
        """Plan and layout in one call (``MeshConfig`` semantics: ``-1``
        is every remaining rank; ``device_type`` as
        :func:`~tpudist_torch.mesh.create_layout` takes it). Every rank
        must call it."""
        if pipe > 1 and fsdp > 1:
            raise NotImplementedError(
                f"ParallelPlan(fsdp={fsdp}, pipe={pipe}) is not ported yet "
                f"(ROADMAP {PIPE_REMAINDER})")
        return cls(create_layout(MeshConfig(data=data, fsdp=fsdp, pipe=pipe,
                                            expert=expert, seq=seq,
                                            tensor=tensor),
                                 device_type=device_type), **kw)

    @property
    def data(self) -> int:
        return self.layout.data

    @property
    def fsdp(self) -> int:
        return self.layout.fsdp

    @property
    def tensor(self) -> int:
        return self.layout.tensor

    @property
    def pipe(self) -> int:
        return self.layout.pipe

    @property
    def expert(self) -> int:
        return self.layout.expert

    @property
    def model_axes(self) -> dict[str, int]:
        """The real (>1) model-parallel axes of this plan."""
        return {k: v for k, v in ((FSDP_AXIS, self.fsdp),
                                  (PIPELINE_AXIS, self.pipe),
                                  (EXPERT_AXIS, self.expert),
                                  (TENSOR_AXIS, self.tensor)) if v > 1}

    def axis_worlds(self) -> dict[str, int]:
        """The geometry keys a checkpoint records for this plan."""
        return {"fsdp_world": self.fsdp, "tensor_world": self.tensor,
                "pipe_world": self.pipe, "expert_world": self.expert}

    def describe(self) -> str:
        return (f"ParallelPlan(data={self.data}, fsdp={self.fsdp}, "
                f"pipe={self.pipe}, tensor={self.tensor}, "
                f"expert={self.expert})")


    @property
    def data_parallel_size(self) -> int:
        return self.layout.data_parallel_size

    def fsdp_spec(self, shape) -> tuple:
        return largest_divisible_spec(tuple(shape), FSDP_AXIS, self.fsdp,
                                      min_size=self.fsdp_min_size)

    def _zero1_skip(self, shape) -> bool:
        return self.wraps_fsdp and bool(self.fsdp_spec(shape))

    def wrap_zero1(self, tx):
        """ZeRO-1 over ``data`` composed with this plan (module docstring):
        the leaves the plan shards over ``fsdp`` stay as FSDP holds them,
        their state sliced again over data where the dim divides; beside
        an fsdp axis the tensor shards stay whole; without one a rank
        slices its tensor shards over its data replicas. The expert
        leaves' state stays whole (``skip_names``: the leaves
        :func:`tpudist_torch.parallel.ep.is_expert_leaf` names)."""
        from tpudist_torch.optim import shard_state

        if self.pipe > 1:
            raise NotImplementedError(
                f"ZeRO-1 beside a pipe axis is not ported yet (ROADMAP "
                f"{PIPE_REMAINDER})")
        return shard_state(tx, self.layout, min_size=self.fsdp_min_size,
                           skip_spec=self._zero1_skip if self.wraps_fsdp
                           else None)

    def validate_reduce(self, reduce) -> None:
        """The explicit reducer reduces over ``data`` alone: refused on a
        plan with a real model axis, naming the fix."""
        if reduce is None or reduce in ("none", "auto") or not isinstance(
                reduce, str):
            return
        axes = self.model_axes
        if axes:
            moved = " * ".join(f"{k}={v}" for k, v in axes.items())
            raise ValueError(
                f"reduce={reduce!r} is pure-DP (the explicit bucketed/"
                "quantized reducer reduces over the 'data' axis only) but "
                f"this plan shards the model over {moved} — keep "
                "reduce='none' (FSDP already reduce-scatters gradients over "
                "'fsdp', and the Megatron layers all-reduce over 'tensor' "
                "in each block), or move those ranks to the data axis "
                "(ParallelPlan.build(data=-1) / MeshConfig(data=-1)) before "
                "asking for the explicit wire format")
