"""Pipeline parallelism: GPipe and 1F1B over a layout's pipe group.

Counterpart of :mod:`tpudist.parallel.pp`. The reference stacks the
repeated blocks ``[n_layers, ...]`` over its ``pipe`` mesh axis and runs
the schedule as one SPMD program; here each rank holds its stage's blocks
``[i * L / S, (i + 1) * L / S)`` (:func:`stage_layers`) and the stages pass
activations to each other by point-to-point ops over the pipe group
(:attr:`tpudist_torch.mesh.RankLayout.pipe_ranks`).

:func:`pipeline_apply` is one ``torch.autograd.Function`` a call: its
forward runs every microbatch through the stage, its backward drives the
reverse ring, so one ``loss.backward()`` runs the whole schedule. The two
ends are the reference's:

- the last stage's outputs reach every pipe rank (the reference's
  ``psum`` over the other stages' zeros), so the head and the loss run
  replicated on every stage;
- in the backward only the last stage feeds its cotangent into the ring
  (every rank holds the same one, nothing is summed over pipe), and stage
  0's input cotangents reach every pipe rank, so the leaves the stages
  replicate (the embeddings) take equal gradients on every stage without
  a reduction.

The schedules (``SCHEDULES``) compute the same function:

- ``"gpipe"``: each microbatch's stage graph is kept from the forward,
  and the backward runs the microbatches in reverse order, as the
  reference's reverse-mode pass through its forward scan does;
- ``"1f1b"``: the forward runs without autograd and banks each
  microbatch's stage input alone; the backward recomputes a microbatch's
  stage forward exactly when its cotangent arrives, in microbatch order
  (the reference's memory contract: ``M`` stage inputs live, not ``M``
  microbatches of block internals).

A stage's parameter gradients sum over microbatches in reverse order
under GPipe and in forward order under 1F1B, so the two agree within
float32 rounding, not bit for bit; their forwards, and so their first
losses, are bit-identical.

Every pair of ops is ordered: a stage receives microbatch ``m`` from the
stage before it, then sends its output for ``m`` to the stage after it
(the backward the other way), so no stage waits on a neighbour that waits
on it. Over gloo a CUDA tensor goes through host memory (gloo's
point-to-point ops read device pointers as host ones), and every tensor
travels as its bytes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["SCHEDULES", "pipe_size", "check_schedule", "stage_layers",
           "pipeline_apply",
           "layer_index", "stage_names", "stage_local_names",
           "stage_state_dict", "gather_stages", "replicas_agree"]

SCHEDULES = ("gpipe", "1f1b")


def pipe_size(layout) -> int:
    """The pipe world of ``layout`` (1 without one)."""
    return getattr(layout, "pipe", 1) if layout is not None else 1


def check_schedule(schedule: str) -> None:
    """The reference's refusal of an unknown schedule."""
    if schedule not in SCHEDULES:
        raise ValueError(
            f"schedule must be one of {SCHEDULES}, got {schedule!r}")


def stage_layers(layers: int, n_stages: int, stage: int) -> range:
    """The layers stage ``stage`` of ``n_stages`` holds: ``[stage * L / S,
    (stage + 1) * L / S)``, after the reference's divisibility check."""
    if layers % n_stages:
        raise ValueError(f"{layers} layers not divisible by {n_stages} "
                         "stages")
    per = layers // n_stages
    return range(stage * per, (stage + 1) * per)


def layer_index(name: str) -> int | None:
    """The block index of a parameter named ``h.{i}.…`` (None for any
    other name)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] == "h" and parts[1].isdigit():
        return int(parts[1])
    return None


def stage_names(names, depth: int, n_stages: int, stage: int) -> list:
    """The names among ``names`` a stage holds: its blocks' and every
    name outside the blocks (replicated over the stages)."""
    held = stage_layers(depth, n_stages, stage)
    return [k for k in names
            if layer_index(k) is None or layer_index(k) in held]


def stage_local_names(names) -> list:
    """The names among ``names`` of block leaves (those a stage holds
    alone)."""
    return [k for k in names if layer_index(k) is not None]


def stage_state_dict(sd: dict, depth: int, layout) -> dict:
    """The entries of a whole state dict that ``layout``'s stage holds
    (all of them with one stage)."""
    pipe = pipe_size(layout)
    if pipe == 1:
        return dict(sd)
    keep = set(stage_names(sd, depth, pipe, layout.pipe_idx))
    return {k: v for k, v in sd.items() if k in keep}


def gather_stages(sd: dict, layout) -> dict:
    """The whole model's entries from every stage's ``sd`` (every pipe
    rank calls it): each replicated entry as this rank holds it, then the
    stages' blocks in layer order, every tensor on ``sd``'s device."""
    mine = {k: v.detach().cpu() for k, v in sd.items()
            if layer_index(k) is not None}
    parts = [None] * layout.pipe
    dist.all_gather_object(parts, mine, group=layout.pipe_group)
    dev = next(iter(sd.values())).device
    return {**{k: v for k, v in sd.items() if layer_index(k) is None},
            **{k: v.to(dev) for part in parts for k, v in part.items()}}


def replicas_agree(sd: dict, layout) -> bool:
    """Whether this rank's entries of ``sd`` outside the blocks (the
    leaves the stages replicate) are bit-equal to those of every rank of
    its pipe group (every pipe rank calls it). Nothing but every stage
    computing the same bits keeps these copies equal; this is the check
    a run can make of it."""
    mine = {k: v.detach().cpu() for k, v in sd.items()
            if layer_index(k) is None}
    parts = [None] * layout.pipe
    dist.all_gather_object(parts, mine, group=layout.pipe_group)
    return all(p.keys() == mine.keys()
               and all(torch.equal(p[k], v) for k, v in mine.items())
               for p in parts)


# -- the wire ------------------------------------------------------------------


def _through_host(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _raw(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the wire moves it: over gloo its bytes (gloo's collectives
    take no 16-bit float on every build)."""
    if _through_host(group):
        return t.reshape(-1).view(torch.uint8)
    return t


def _send(t: torch.Tensor, dst: int, group) -> None:
    t = t.detach().contiguous()
    if _through_host(group) and t.is_cuda:
        t = t.cpu()
    dist.send(_raw(t, group), dst, group=group)


def _recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    host = _through_host(group) and like.is_cuda
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if host else like.device)
    dist.recv(_raw(buf, group), src, group=group)
    return buf.to(like.device, non_blocking=True) if host else buf


def _broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    host = _through_host(group) and t.is_cuda
    buf = t.cpu() if host else t.contiguous()
    dist.broadcast(_raw(buf, group), src, group=group)
    return buf.to(t.device) if host else buf


# -- the schedule --------------------------------------------------------------


class _Run:
    """What one :func:`pipeline_apply` call's schedule reads."""

    def __init__(self, stage_fn, params, layout, num_micro, schedule):
        self.stage_fn = stage_fn
        self.params = params
        self.layout = layout
        self.num_micro = num_micro
        self.schedule = schedule
        # a forward under no_grad keeps nothing for a backward
        self.keep = torch.is_grad_enabled()


def _accumulate(sums: list, grads) -> None:
    for i, g in enumerate(grads):
        if g is None:
            continue
        sums[i] = g if sums[i] is None else sums[i] + g


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, run: _Run, *params):
        lay = run.layout
        n, s, group = lay.pipe, lay.pipe_idx, lay.pipe_group
        xs = x.detach().chunk(run.num_micro)
        outs, saved = [], []
        for m, xm in enumerate(xs):
            inp = xm if s == 0 else _recv(xm, lay.prev_stage, group)
            if run.keep and run.schedule == "gpipe":
                inp = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = run.stage_fn(inp)
                saved.append((inp, y))
            else:
                if run.keep:
                    saved.append(inp)
                y = run.stage_fn(inp)
            if s < n - 1:
                _send(y, lay.next_stage, group)
            else:
                outs.append(y.detach())
        # the last stage's outputs, on every stage
        out = torch.cat(outs) if s == n - 1 else torch.empty_like(x)
        out = _broadcast(out, lay.pipe_ranks[-1], group)
        ctx.run, ctx.saved, ctx.like = run, saved, xs[0]
        return out

    @staticmethod
    def backward(ctx, g):
        run, saved = ctx.run, ctx.saved
        lay = run.layout
        n, s, group = lay.pipe, lay.pipe_idx, lay.pipe_group
        nm = run.num_micro
        gs = g.contiguous().chunk(nm)
        sums = [None] * len(run.params)
        dxs = [None] * nm
        order = (reversed(range(nm)) if run.schedule == "gpipe"
                 else range(nm))
        for m in order:
            # only the last stage's cotangent enters the ring
            ct = gs[m] if s == n - 1 else _recv(gs[m], lay.next_stage,
                                                group)
            if run.schedule == "gpipe":
                inp, y = saved[m]
                saved[m] = None
            else:
                inp = saved[m].detach().requires_grad_(True)
                saved[m] = None
                with torch.enable_grad():
                    y = run.stage_fn(inp)
            dinp, *dp = torch.autograd.grad(y, (inp, *run.params), ct,
                                            allow_unused=True)
            _accumulate(sums, dp)
            if s > 0:
                _send(dinp, lay.prev_stage, group)
            else:
                dxs[m] = dinp
        # stage 0's input cotangents, on every stage
        dx = (torch.cat(dxs) if s == 0 else
              torch.empty(g.shape, dtype=ctx.like.dtype, device=g.device))
        dx = _broadcast(dx, lay.pipe_ranks[0], group)
        ctx.saved = None
        return (dx, None, *sums)


def pipeline_apply(stage_fn, x: torch.Tensor, layout, *, num_micro: int,
                   schedule: str = "gpipe", params=None) -> torch.Tensor:
    """Run ``x`` (this rank's batch, ``[B, ...]``) through every stage of
    ``layout``'s pipe group: ``stage_fn(h) -> h`` applies this rank's
    stage (its blocks in order; the same shape and dtype out as in),
    ``params`` the tensors it reads that take gradients (by default
    ``stage_fn.parameters()``, for a module). The batch splits into
    ``num_micro`` microbatches along dim 0; the result, on every pipe
    rank, is the last stage's output for the whole batch. With one stage
    the stage runs on the whole batch. ``schedule``: ``"gpipe"`` or
    ``"1f1b"`` (module docstring)."""
    check_schedule(schedule)
    b = x.shape[0]
    if b % num_micro:
        raise ValueError(f"batch {b} not divisible by num_micro {num_micro}")
    if pipe_size(layout) == 1:
        return stage_fn(x)
    if params is None:
        params = list(stage_fn.parameters())
    run = _Run(stage_fn, list(params), layout, num_micro, schedule)
    return _Pipeline.apply(x, run, *run.params)
