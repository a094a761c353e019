"""The data-parallel training step and epoch driver.

Counterpart of the core of :mod:`tpudist.train` that ``main.py``'s default
path and ``--fused`` use. The reference's step is one compiled SPMD
program; here it is the eager sequence the original PyTorch job ran,
with the reference's numerics:

- the module is wrapped in ``DistributedDataParallel`` under a process
  group (``broadcast_buffers=False``: the BN running statistics are
  already global), so the gradients DDP all-reduces and averages are those
  of the global-batch mean loss; BN statistics span the global batch
  (:class:`tpudist_torch.models.resnet.BatchNorm`);
- the update is optax-order Adam/AdamW (:mod:`tpudist_torch.optim`),
  through the fused kernel under ``fused="optimizer"``;
- under the fused optimizer with a compute copy the module's parameters
  ARE the copy, so the forward reads it, DDP reduces exactly the
  gradients the optimizer reads, and the kernel writes the next copy
  straight into the parameters' storage;
- nothing in the step reads the device: the loss is copied into pinned
  host memory with ``non_blocking=True`` behind an event and resolved
  after the next step has been dispatched (the reference's one-step-
  delayed fetch), and the optimizer's scalars come from a host counter;
- ``grad_accum > 1`` splits the batch into a leading microbatch dim and
  sums the microbatches' gradients in float32 under DDP's ``no_sync``, then
  all-reduces the sums once per step (module :func:`make_train_step`);
- ``fused="ln"`` switches the model's ``fused_ln`` knob on (the same
  parameters; GPT-2's fused residual-add + LayerNorm kernel).

``fit`` raises ``NotImplementedError`` for every feature of the
reference's ``fit`` that is not ported yet, naming its ROADMAP item; none
is a silent no-op.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpudist_torch.data.loader import prefetch_to_device
from tpudist_torch.distributed import group_up
from tpudist_torch.metrics import MetricsLogger
from tpudist_torch.optim import Adam, AdamState, FusedAdamWState
from tpudist_torch.profiling import WindowedProfiler


@dataclasses.dataclass
class TrainState:
    """``step``: optimizer steps taken; ``model``: the module (the
    forward's parameters and the BN running statistics); ``module``: what
    the step calls, ``DistributedDataParallel(model)`` under a process
    group and ``model`` otherwise; ``opt_state``: the optimizer's state."""

    step: int
    model: nn.Module
    module: nn.Module
    opt_state: AdamState

    def params(self) -> dict[str, torch.Tensor]:
        """The float32 master of every parameter, by name."""
        if isinstance(self.opt_state, FusedAdamWState):
            params = self.opt_state.master
        else:
            params = dict(self.model.named_parameters())
        return {k: p.detach() for k, p in params.items()}

    def batch_stats(self) -> dict[str, torch.Tensor]:
        """The BN running statistics, by buffer name."""
        return dict(self.model.named_buffers())


def cross_entropy_loss(logits, labels):
    """Softmax cross-entropy on logits against integer labels, the batch
    mean (the reference's ``CrossEntropyLoss``)."""
    return F.cross_entropy(logits.float(), labels.long())


def smoothed_cross_entropy(smoothing: float) -> Callable:
    """Cross-entropy against ``(1 - eps) * one_hot + eps / n`` targets
    (optax's ``smooth_labels``); ``eps = 0`` is :func:`cross_entropy_loss`."""

    def loss_fn(logits, labels):
        logp = F.log_softmax(logits.float(), dim=-1)
        n = logits.shape[-1]
        targets = (1.0 - smoothing) * F.one_hot(labels.long(), n) + smoothing / n
        return -(targets * logp).sum(-1).mean()

    return loss_fn


def lm_loss(logits, tokens):
    """Next-token cross-entropy: predict ``tokens[:, 1:]`` from
    ``logits[:, :-1]`` in float32, the mean over those positions (the
    reference's ``lm_loss``). The last position's target is ignored
    instead of sliced off, so the ``[B, S, V]`` logits are not copied."""
    targets = torch.full_like(tokens, -100, dtype=torch.long)
    targets[:, :-1] = tokens[:, 1:]
    v = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, v).float(), targets.reshape(-1),
                           ignore_index=-100)


def create_train_state(model: nn.Module, tx: Adam) -> TrainState:
    """Build the optimizer state from ``model``'s parameters (the fused
    optimizer with a compute copy turns them into the copy here) and wrap
    the module in DDP when a process group is up. Every rank builds the
    model from the same seed; DDP's broadcast from rank 0 at wrap time is
    the reference's init-sync."""
    opt_state = tx.init(dict(model.named_parameters()))
    module = model
    if group_up():
        dev = next(model.parameters()).device
        module = nn.parallel.DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            broadcast_buffers=False)
    return TrainState(0, model, module, opt_state)


def resolve_fused(fused, model, tx) -> frozenset:
    """Resolve a ``fused=`` request against what the model and optimizer
    support, as the reference does: ``None``/``"none"`` -> nothing;
    ``"auto"`` -> what is available; ``"ln"``/``"optimizer"``/``"all"``
    demand their side and raise when it is unsupported."""
    if not fused or fused == "none":
        return frozenset()
    if fused is True:
        fused = "auto"
    if fused not in ("auto", "ln", "optimizer", "all"):
        raise ValueError(f"fused={fused!r}: expected None/'none'/'auto'/'ln'/"
                         "'optimizer'/'all'")
    ln_ok = hasattr(model, "fused_ln")
    opt_ok = getattr(tx, "fused", False)
    out = set()
    if fused in ("ln", "all") or (fused == "auto" and ln_ok):
        if not ln_ok:
            raise ValueError(
                f"fused={fused!r} requests the fused LN path but "
                f"{type(model).__name__} has no fused_ln knob (the "
                "GPT-2/Llama/BERT/ViT families carry it)")
        out.add("ln")
    if fused in ("optimizer", "all") or (fused == "auto" and opt_ok):
        if not opt_ok:
            raise ValueError(
                f"fused={fused!r} requests the fused-optimizer path but the "
                "optimizer is not tpudist_torch.optim.fused_adamw (build one "
                "with make_optimizer(fused=True))")
        out.add("optimizer")
    return frozenset(out)


def make_train_step(model, tx: Adam, *, loss_fn: Callable = cross_entropy_loss,
                    input_key: str = "image", label_key: str = "label",
                    fused=None, grad_accum: int = 1, reduce: str = "none"):
    """Build ``step(state, batch) -> (state, {"loss": tensor})``: forward,
    loss, backward (DDP all-reduces the gradients under a group), one
    optimizer update. ``state`` is updated in place; ``batch`` is a dict of
    tensors on the model's device (NHWC images and integer labels, or
    ``"tokens"`` for a language model, which is both input and label).

    ``grad_accum > 1``: the batch's leading dim is ``grad_accum``
    microbatches; each runs forward and backward under DDP's ``no_sync``,
    its gradients are added into float32 sums, and the sums are
    all-reduced once per step in one flat buffer and divided by
    ``grad_accum``, as is the loss (the reference's microbatch scan with
    float32 accumulators). DDP's own reduction is not used there: it would
    sum the microbatches in the parameters' dtype, which is bf16 under the
    fused optimizer's compute copy."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if reduce not in (None, "none"):
        raise NotImplementedError(
            f"reduce={reduce!r} is not ported yet (ROADMAP Queue 1 #7); "
            "DDP's all-reduce is the port's 'none'")
    fused_set = resolve_fused(fused, model, tx)
    if "optimizer" not in fused_set and getattr(tx, "compute_dtype", None):
        raise ValueError(
            "a fused_adamw with a compute copy feeds the forward from the "
            "copy; build the step with fused='optimizer' (or 'auto')")

    if "ln" in fused_set:
        # the reference's clone with fused_ln=True: the same parameters,
        # the LayerNorms through the fused kernel
        model.fused_ln = True

    def forward_loss(module, batch):
        return loss_fn(module(batch[input_key]), batch[label_key])

    def accumulate(state, batch, params):
        micro = {k: v.reshape(grad_accum, -1, *v.shape[1:])
                 for k, v in batch.items()}
        sums = {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}
        lsum = torch.zeros((), dtype=torch.float32,
                           device=next(iter(sums.values())).device)
        ddp = isinstance(state.module, nn.parallel.DistributedDataParallel)
        with state.module.no_sync() if ddp else contextlib.nullcontext():
            for i in range(grad_accum):
                loss = forward_loss(state.module,
                                    {k: v[i] for k, v in micro.items()})
                loss.backward()
                for k, p in params.items():
                    if p.grad is not None:
                        sums[k] += p.grad
                        p.grad = None
                lsum += loss.detach()
        if group_up():
            flat = torch.cat([t.reshape(-1) for t in sums.values()])
            dist.all_reduce(flat)
            flat /= dist.get_world_size()
            sums = dict(zip(sums, flat.split([t.numel()
                                               for t in sums.values()])))
            sums = {k: t.view_as(params[k]) for k, t in sums.items()}
        return lsum / grad_accum, {k: t / grad_accum for k, t in sums.items()}

    def step(state: TrainState, batch: dict):
        state.module.train()
        params = dict(state.model.named_parameters())
        for p in params.values():
            p.grad = None
        if grad_accum == 1:
            loss = forward_loss(state.module, batch)
            loss.backward()
            grads = {k: p.grad for k, p in params.items()}
        else:
            loss, grads = accumulate(state, batch, params)
        tx.step(state.opt_state, params, grads)
        state.step += 1
        loss = loss.detach()
        if group_up():
            # the global-batch mean, as the reference's loss is (ranks hold
            # equal batches); a SUM, because gloo has no AVG
            loss = loss.clone()
            dist.all_reduce(loss)
            loss /= dist.get_world_size()
        return state, {"loss": loss}

    step.fused = fused_set
    return step


class _DelayedLoss:
    """One-step-delayed loss fetch: :meth:`start` copies the device loss
    into one of two pinned host buffers behind an event; :meth:`value`
    waits for that event only, after the next step is dispatched."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.bufs = [torch.empty((), dtype=torch.float32, pin_memory=self.cuda)
                     for _ in range(2)]
        self.turn = 0

    def start(self, loss: torch.Tensor):
        buf = self.bufs[self.turn]
        self.turn ^= 1
        buf.copy_(loss, non_blocking=True)
        ready = None
        if self.cuda:
            ready = torch.cuda.Event()
            ready.record()
        return buf, ready

    @staticmethod
    def value(handle) -> float:
        buf, ready = handle
        if ready is not None:
            ready.synchronize()
        return float(buf)


_DEFERRED = {
    # fit() keyword: (value meaning "off", ROADMAP item)
    "reduce": ("none", "Queue 1 #7"),
    "plan": (None, "Queue 1 #7"),
    "shard_opt_state": (False, "Queue 1 #7"),
    "telemetry": (False, "Queue 1 #8"),
    "metrics_port": (None, "Queue 1 #8"),
    "checkpoint_dir": (None, "Queue 1 #4"),
    "elastic": (False, "Queue 1 #9"),
    "chaos": (None, "Queue 1 #9"),
    "repair": (None, "Queue 1 #9"),
    "compile_cache": (None, "Queue 1 #9"),
}


def fit(model: nn.Module, tx: Adam, train_loader, *, epochs: int,
        job_id: str = "Job0", batch_size: int | None = None,
        world_size: int | None = None, global_rank: int | None = None,
        loss_fn: Callable = cross_entropy_loss, input_key: str = "image",
        label_key: str = "label", fused=None, grad_accum: int = 1,
        profile: bool = True, prefetch_depth: int = 2, log_dir: str = ".",
        metrics_logger: MetricsLogger | None = None, **deferred):
    """The reference's training program as a function: epochs x batches,
    the per-epoch sampler re-shuffle, the windowed profiler, the TSV
    metrics and the TrainTime footer. ``model`` carries its initial
    weights (built from a seed on every rank) and its device; the loader
    yields host batches of numpy arrays. Returns ``(state, losses)``, the
    per-step losses in step order. With ``grad_accum > 1`` each loader
    batch holds ``grad_accum`` microbatches (see :func:`make_train_step`).

    The reference's other keywords (``reduce``, ``plan``,
    ``shard_opt_state``, ``telemetry``, ``metrics_port``,
    ``checkpoint_dir``, ``elastic``, ``chaos``, ``repair``,
    ``compile_cache``) are accepted and raise ``NotImplementedError``
    naming their ROADMAP item unless they are at their "off" value."""
    for key, value in deferred.items():
        if key not in _DEFERRED:
            raise TypeError(f"fit() got an unexpected keyword argument {key!r}")
        off, item = _DEFERRED[key]
        if value != off and not (key == "reduce" and value is None):
            raise NotImplementedError(
                f"fit({key}={value!r}) is not ported yet (ROADMAP {item})")
    device = next(model.parameters()).device
    if world_size is None:
        world_size = dist.get_world_size() if group_up() else 1
    if global_rank is None:
        global_rank = dist.get_rank() if group_up() else 0
    if batch_size is None:
        batch_size = train_loader.batch_size
    step = make_train_step(model, tx, loss_fn=loss_fn, input_key=input_key,
                           label_key=label_key, fused=fused,
                           grad_accum=grad_accum)
    state = create_train_state(model, tx)
    fetch = _DelayedLoss(device)
    losses: list[float] = []
    logger = metrics_logger or MetricsLogger(
        job_id, batch_size, global_rank, world_size, log_dir=log_dir)
    with logger, WindowedProfiler(job_id, enabled=profile,
                                  log_dir=f"{log_dir}/log_{job_id}",
                                  device=device) as prof:
        print("Start")
        pending = None  # (global_step, epoch, idx, start, loss handle)

        def resolve(now: float) -> None:
            g, e, idx, start, handle = pending
            loss_value = fetch.value(handle)
            losses.append(loss_value)
            logger.log_step(g, loss_value, now - start)
            logger.print_progress(e, idx, loss_value)

        global_step = 0
        logger.start_timer()
        try:
            for e in range(epochs):
                if hasattr(train_loader, "sampler"):
                    train_loader.sampler.set_epoch(e)
                staged = prefetch_to_device(iter(train_loader), device,
                                            depth=prefetch_depth)
                for idx, batch in enumerate(staged):
                    start = time.time()
                    global_step += 1
                    state, metrics = step(state, batch)
                    handle = fetch.start(metrics["loss"])
                    prof.step()
                    if pending is not None:
                        resolve(start)
                    pending = (global_step, e, idx, start, handle)
        except BaseException:
            # flush the last completed step before the error leaves, but
            # never mask the error with a failing fetch
            if pending is not None:
                try:
                    resolve(time.time())
                except Exception:
                    pass
            raise
        if pending is not None:
            resolve(time.time())
    return state, losses


@torch.no_grad()
def evaluate(state: TrainState, loader, *, input_key: str = "image",
             label_key: str = "label") -> float:
    """Top-1 accuracy of ``state.model`` (running BN statistics) over every
    sample of ``loader``. Under a process group the hit and row counts are
    summed over the ranks, so each rank may hold the full validation set
    (the reference's convention) or its own shard."""
    model = state.model
    model.eval()
    device = next(model.parameters()).device
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    for batch in prefetch_to_device(iter(loader), device):
        logits = model(batch[input_key])
        labels = batch[label_key].long()
        counts[0] += (logits.argmax(-1) == labels).sum()
        counts[1] += labels.numel()
    if group_up():
        dist.all_reduce(counts)
    hits, total = counts.tolist()
    return hits / max(total, 1)
