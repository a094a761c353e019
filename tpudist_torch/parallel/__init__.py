"""Parallelism strategies: the data-parallel layers (the explicit
reducer, FSDP, the plan), context parallelism (:mod:`.cp`), tensor
parallelism (:mod:`.tp`: the Megatron layers) and the pipeline
(:mod:`.pp`: GPipe and 1F1B)."""

from tpudist_torch.parallel.dp import GradReducer, make_reducer, resolve_method
from tpudist_torch.parallel.fsdp import apply_fsdp, fsdp_spec
from tpudist_torch.parallel.plan import ParallelPlan, spec_is_sharded

__all__ = [
    "GradReducer", "make_reducer", "resolve_method",
    "apply_fsdp", "fsdp_spec",
    "ParallelPlan", "spec_is_sharded",
]
