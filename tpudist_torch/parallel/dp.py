"""Explicit data-parallel gradient reduction: the bucketed and int8 reducer.

Counterpart of :mod:`tpudist.parallel.dp`. The port's default step hands
the reduction to DDP (``reduce="none"``); ``make_train_step(reduce=...)``
takes it explicitly instead, with the reference's semantics:

- no DDP wrapper: each rank computes the gradients of its local-batch
  mean loss, flattens them into buckets (:class:`tpudist_torch.allreduce.
  BucketLayout`, the port's parameter order) and reduces them over its
  data replicas: ``"bucketed"`` as one float32 all-reduce, ``"quantized"``
  as int8 on the wire with per-bucket scales, stochastic rounding, float32
  accumulation and an error-feedback residual (:func:`tpudist_torch.allreduce.
  reduce_buckets`). One scalar all-reduce gives the global-mean loss;
- BatchNorm takes LOCAL batch statistics on this path, and the updated
  running statistics are averaged over the replicas (the DDP default, not
  the cross-replica BatchNorm of ``reduce="none"``);
- dropout masks are per replica (the key carries the rank), as on every
  path of the port;
- with ``grad_accum > 1`` and error feedback, microbatch ``i - 1``'s
  buckets are reduced while microbatch ``i`` computes (on the card on a
  side CUDA stream, so the ring can overlap the backward); iteration 0
  reduces the zero buffer, which flushes the residual, and one drain after
  the loop reduces the last microbatch: ``grad_accum + 1`` reductions a
  step. Without a residual the microbatches accumulate locally and reduce
  once.

The error-feedback residual is ``[n_buckets, bucket_size]`` float32 on
each rank (its own quantization error), held in the train state's
``comm_residual``, saved in checkpoints and attached by ``fit``.
``reduce="auto"`` gives ``"quantized"`` only when the data replicas span
more than one host on a data-only layout, and ``"none"`` otherwise; a
world of one data replica has nothing to reduce. An explicit method on a
layout with an ``fsdp`` axis or ``seq > 1`` raises and names the fix, as
the reference refuses it.

The reference's divergence probe and reduction time probe belong to the
telemetry layer (ROADMAP Queue 1 #8) and raise here.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpudist_torch import allreduce as comm
from tpudist_torch.rng import fold_in

METHODS = ("none", "bucketed", "quantized", "auto")


def _refuse(method: str, layout) -> None:
    if layout.fsdp > 1:
        raise ValueError(
            f"reduce={method!r} is pure-DP (the explicit bucketed/quantized "
            "reducer reduces over the 'data' axis only) but this layout "
            f"shards the model over fsdp={layout.fsdp} — keep reduce='none' "
            "(FSDP already reduce-scatters gradients over 'fsdp'), or move "
            "those ranks to the data axis (MeshConfig(data=-1, fsdp=1)) "
            "before asking for the explicit wire format")
    if layout.seq > 1:
        raise ValueError(
            f"reduce={method!r} is pure-DP but this layout splits each "
            f"sequence over seq={layout.seq} (context parallelism keeps the "
            "default reduction) — keep reduce='none', or drop --cp")


def resolve_method(method: str, layout) -> str:
    """The method to run on ``layout`` (module docstring)."""
    if method not in METHODS:
        raise ValueError(f"reduce must be one of {METHODS}, got {method!r}")
    if method in ("bucketed", "quantized"):
        _refuse(method, layout)
    if layout.data <= 1 or method == "none":
        return "none"
    if method == "auto":
        if layout.fsdp > 1 or layout.seq > 1:
            return "none"
        return "quantized" if comm.multihost() else "none"
    return method


class GradReducer:
    """The reducer ``make_train_step(reduce=...)`` builds: the method, the
    bucket size and the stochastic-rounding seed (error feedback is on
    exactly where the wire is lossy: ``"quantized"``), over
    ``ring`` (a :class:`tpudist_torch.allreduce.GroupRing` over the layout's
    data group by default; a :class:`~tpudist_torch.allreduce.LoopbackRing`
    holds every replica in one process)."""

    def __init__(self, layout, method: str, *,
                 bucket_size: int = comm.DEFAULT_BUCKET_ELEMS,
                 seed: int = 0, ring=None):
        if method not in ("bucketed", "quantized"):
            raise ValueError(
                f"GradReducer method must be 'bucketed' or 'quantized', got "
                f"{method!r} (resolve 'auto' via resolve_method first)")
        if layout is not None:
            _refuse(method, layout)
        self.method = method
        self.bucket_size = int(bucket_size)
        self.error_feedback = method == "quantized"
        self.seed = int(seed)
        self.ring = ring if ring is not None else comm.GroupRing(
            layout.data_group)
        self.world = self.ring.n

    def layout_for(self, params: dict) -> comm.BucketLayout:
        return comm.BucketLayout(params, self.world,
                                 bucket_size=self.bucket_size)

    def new_residual(self, params: dict) -> torch.Tensor | None:
        """A zeroed residual for ``params`` (None without error
        feedback): ``[R, n_buckets, bucket_size]``, ``R`` the ring's
        ranks in this process."""
        if not self.error_feedback:
            return None
        layout = self.layout_for(params)
        dev = next(iter(params.values())).device
        return torch.zeros((len(self.ring.ranks), layout.n_buckets,
                            layout.bucket_size), dtype=torch.float32,
                           device=dev)

    def keys(self, step: int, micro: int) -> list[int] | None:
        """The stochastic-rounding keys of one reduction, one per rank
        in this process: (seed, step, replica, microbatch)."""
        if self.method != "quantized":
            return None
        return [fold_in(self.seed, step, r, micro) for r in self.ring.ranks]

    def reduce(self, buckets, residual, layout, step: int, micro: int):
        """One reduction of ``buckets [R, n_buckets, bucket_size]``:
        ``(mean, new_residual)``."""
        return comm.reduce_buckets(buckets, residual, layout, self.ring,
                                   self.keys(step, micro),
                                   method=self.method)

    def compute(self, grad_fn: Callable, names: list, grad_accum: int,
                step: int, residual):
        """The step's gradient block on one rank of a group.
        ``grad_fn(i) -> (loss, grads)``: microbatch ``i``'s local loss and
        its gradients by name. Returns ``(local mean loss, mean gradients
        by name, new residual)``; the gradients are float32 views of one
        buffer that every replica holds bit for bit."""
        if self.error_feedback and residual is None:
            raise ValueError(
                "reduce='quantized' with error feedback needs the residual "
                "in the train state: attach it with "
                "step.grad_reducer.new_residual (fit() does this)")
        layout = None

        def flat(grads):
            nonlocal layout
            if layout is None:
                layout = self.layout_for({k: grads[k] for k in names})
            return layout.flatten(grads)[None]

        def div(t, n):
            return t / torch.full((), float(n), device=t.device)

        r = residual
        loss, g = grad_fn(0)
        if grad_accum == 1:
            mean, r = self.reduce(flat(g), r, layout, step, 0)
        elif self.error_feedback:
            pending = flat(g)
            side = _side_stream(pending)
            # iteration 0 reduces the zero buffer: the residual's flush
            rsum, r = self._reduce_on(side, torch.zeros_like(pending), r,
                                      layout, step, 0)
            for i in range(1, grad_accum):
                # microbatch i-1's buckets reduce while microbatch i runs
                red, r = self._reduce_on(side, pending, r, layout, step, i)
                l_i, g = grad_fn(i)
                loss = loss + l_i
                _join(side, red, rsum, r)
                rsum = rsum + red
                pending = flat(g)
            red, r = self.reduce(pending, r, layout, step, grad_accum)
            mean = div(rsum + red, grad_accum)
            loss = loss / grad_accum
        else:
            gsum = flat(g)
            for i in range(1, grad_accum):
                l_i, g = grad_fn(i)
                loss = loss + l_i
                gsum = gsum + flat(g)
            mean, r = self.reduce(gsum, r, layout, step, 0)
            mean = div(mean, grad_accum)
            loss = loss / grad_accum
        return loss, layout.unflatten(mean[0]), r

    def _reduce_on(self, side, buckets, residual, layout, step, micro):
        if side is None:
            return self.reduce(buckets, residual, layout, step, micro)
        side.wait_stream(torch.cuda.current_stream(buckets.device))
        with torch.cuda.stream(side):
            buckets.record_stream(side)
            if residual is not None:
                residual.record_stream(side)
            return self.reduce(buckets, residual, layout, step, micro)

    def reductions_per_step(self, grad_accum: int) -> int:
        if grad_accum == 1 or not self.error_feedback:
            return 1
        return grad_accum + 1

    def comm_stats(self, params: dict, grad_accum: int = 1) -> dict:
        """One step's wire accounting (the reference's keys): the method's
        bytes, the same schedule's float32 bytes, and the single float32
        all-reduce of the default path."""
        layout = self.layout_for(params)
        r = self.reductions_per_step(grad_accum)
        return {
            "method": self.method,
            "world": self.world,
            "bucket_size": layout.bucket_size,
            "n_buckets": layout.n_buckets,
            "grad_elems": layout.total,
            "error_feedback": self.error_feedback,
            "reductions_per_step": r,
            "bytes_per_step": layout.wire_bytes(self.method, reductions=r),
            "fp32_bytes_per_step": layout.wire_bytes("bucketed",
                                                     reductions=r),
            "implicit_fp32_bytes_per_step": layout.wire_bytes("bucketed"),
        }

    def time_probe(self, *args, **kwargs):
        raise NotImplementedError(
            "GradReducer.time_probe is the telemetry layer's comm column "
            "(ROADMAP Queue 1 #8)")


def _side_stream(t: torch.Tensor):
    if t.device.type != "cuda":
        return None
    return torch.cuda.Stream(device=t.device)


def _join(side, *made) -> None:
    """The current stream waits for ``side``; the tensors ``made`` there
    are marked as used here, so the allocator does not hand their memory
    back to ``side`` while this stream still reads them."""
    if side is None:
        return
    main = torch.cuda.current_stream()
    main.wait_stream(side)
    for t in made:
        if t is not None:
            t.record_stream(main)


def make_reducer(reduce, layout, *,
                 bucket_size: int = comm.DEFAULT_BUCKET_ELEMS,
                 seed: int = 0) -> GradReducer | None:
    """``make_train_step``'s constructor: a method name or a built
    :class:`GradReducer` -> the reducer, or None for the default path."""
    if isinstance(reduce, GradReducer):
        return reduce
    method = resolve_method("none" if reduce is None else reduce, layout)
    if method == "none":
        return None
    return GradReducer(layout, method, bucket_size=bucket_size, seed=seed)


def make_divergence_probe(*args, **kwargs):
    raise NotImplementedError(
        "make_divergence_probe belongs to the telemetry layer (ROADMAP "
        "Queue 1 #8)")
