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
- the update is one of :mod:`tpudist_torch.optim`'s optax-order
  optimizers (Adam/AdamW through the fused kernel under
  ``fused="optimizer"``), optionally behind the ``--amp`` guard
  (:func:`tpudist_torch.amp.skip_nonfinite`, whose skip counter rides the
  optimizer state and whose flag is read a step late, like the loss);
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
  all-reduces the sums once per step (module :func:`make_train_step`); a
  ResNet's BatchNorm updates its running statistics once per microbatch,
  in microbatch order, as the reference's scan threads them, each over
  the global microbatch (its statistics are all-reduced in the forward,
  which ``no_sync`` does not touch);
- ``fused="ln"`` switches the model's ``fused_ln`` knob on (the same
  parameters; the fused residual-add + LayerNorm kernel of GPT-2 and
  ViT);
- ``forward_loss(module, batch) -> loss`` replaces the default
  ``loss_fn(module(batch[input_key]), batch[label_key])`` (the chunked LM
  loss, :func:`tpudist_torch.models.lm_utils.chunked_lm_forward`);
- ``input_transform`` runs on the model's input inside the step (the
  device cache's gather, the device ToTensor or augmentation), with the
  reference's calling convention (:func:`_apply_input_transform`);
- ``remat`` checkpoints the model's whole forward under a named policy
  (:mod:`tpudist_torch.remat`), inside DDP; the loss stays outside the
  checkpoint, so the backward recomputes the model and not the loss;
- a model with ``dropout > 0`` draws its masks from a key of
  ``(dropout_seed, rank, step)`` (``step * grad_accum + microbatch`` under
  ``grad_accum``), passed to its forward as ``dropout_key``: fresh every
  step and microbatch, independent across ranks (the reference draws one
  mask over the global batch), and drawn again bit for bit on recompute;
- ``layout`` (a :class:`tpudist_torch.mesh.RankLayout` of more than one
  seq rank) shards each sequence over the rank's seq group, the
  reference's ``batch_spec`` over ``(data, seq)``: every rank holds its
  data replica's whole ``[B, S]`` token rows (cheap int32) and feeds the
  model its chunk (:func:`tpudist_torch.models.lm_utils.seq_shard_lm`),
  whose context-parallel attention spans the group. Its loss is its
  chunk's next-token CE sum over the replica's ``B (S - 1)`` positions, so
  the seq group's losses add up to the replica's mean. DDP averages the
  gradients over all ``data * seq`` ranks, and the reference's gradient is
  the mean over data replicas of the SUM over seq chunks: each rank's
  backward runs on its loss times ``seq`` (exact for a power of two), the
  same all-reduce, no second group. The logged loss is the sum over the
  ranks divided by ``data``: the global mean. Dropout under CP draws its
  masks keyed by the global rank (:func:`dropout_key`), as a data-parallel
  rank does; no bit parity with the reference's one global mask is
  claimed.

The data-parallel layers of the reference (Queue 1 #7's first half):

- ``reduce="bucketed"|"quantized"|"auto"`` takes the gradient reduction
  out of DDP into the explicit reducer (:mod:`tpudist_torch.parallel.dp`):
  no DDP wrapper, local BatchNorm statistics whose running averages are
  averaged over the replicas, the error-feedback residual in
  ``state.comm_residual``;
- ``plan`` (:class:`tpudist_torch.parallel.plan.ParallelPlan`) with an
  ``fsdp`` axis shards every block and the root with FSDP2
  (:mod:`tpudist_torch.parallel.fsdp`) over ``data x fsdp``: no DDP,
  FSDP reduce-scatters the sharded leaves' gradients, the step
  all-reduces the replicated ones;
- ``shard_opt_state`` is ZeRO-1 (:func:`tpudist_torch.optim.shard_state`,
  through ``plan.wrap_zero1`` under a plan);
- ``elastic`` resumes a checkpoint written at another data world
  (:mod:`tpudist_torch.resilience.elastic`).

Tensor parallelism (Queue 1 #7b): a ``layout`` with a tensor axis over a
model built on it (:mod:`tpudist_torch.parallel.tp`: GPT-2, Llama, ViT,
BERT, T5) runs DDP over the ranks with this rank's tensor index alone
(the layout's ``batch_group``: its data replicas, and its seq peers under
a seq axis; the tensor ranks of a replica share its batch) and the
optimizer's clip and ``--amp`` flag over the tensor group
(:meth:`tpudist_torch.optim.Optimizer.shard_over`: a sharded leaf's
squares summed over it, a replicated one counted once). Composed with a
plan's fsdp axis, FSDP2 shards what the tensor axis leaves whole over the
same ranks and the step averages every other gradient over them; with a
seq axis, a causal LM's loss is its chunk's vocabulary-parallel CE sum
over the replica's positions (each count and gradient taken once: the
backward on ``loss x seq``, the average over the batch group).
A causal LM's (``model.causal_lm``: GPT-2, Llama) default loss is
:func:`tpudist_torch.parallel.tp.vocab_parallel_cross_entropy` on the
vocabulary-local logits; ViT's is
``loss_fn`` on its replicated logits. A replicated leaf must hold the
same gradient on every tensor rank, or the ranks' copies part silently:

- a leaf every rank reads whole (the LayerNorms, ``wpe``, ViT's head)
  gets it as it is, because its input is replicated and the gradient of
  that input is summed over the group by
  :func:`~tpudist_torch.parallel.tp.copy_to_tensor`'s backward where it
  enters a column-parallel layer;
- a leaf a rank reads only in part (BERT's MLM bias, over the rank's
  vocabulary columns; T5's relative-bias tables, over its heads) gets a
  partial gradient on each rank, which must be summed over the tensor
  group before the optimizer: the models read such a leaf through
  :func:`~tpudist_torch.parallel.tp.copy_to_tensor`, whose backward is
  that sum, so the step adds no pass of its own.

A checkpoint holds the shards as DTensors on the layout's DeviceMesh
(replicated over its other axes) and records ``tensor_world``.

Experts (Queue 1 #7d): a model with ``has_aux_loss`` (GPT-2 or Llama
with ``num_experts > 0``, :mod:`tpudist_torch.parallel.ep`) adds its MoE
layers' scaled aux (and z-) losses of the forward to the task loss on
the default path (a ``forward_loss`` adds them itself:
:func:`tpudist_torch.models.lm_utils.chunked_lm_forward`); its routers'
jitter draws from the dropout stream, keyed like the dropout masks by the
rank without its tensor and expert indices, so every rank of an expert or
tensor group draws the same noise (a ``forward_loss``, which has no
stream, is refused with jitter on, as the reference refuses it). On a
layout with an expert axis a rank holds its experts; DDP runs over the
batch group (the ranks with this rank's expert and tensor indices, which
hold the same experts), so an expert leaf is averaged over the replicas
that hold it and never over another expert rank; the optimizer's clip and
``--amp`` flag sum an expert leaf's squares over the expert group and
count a replicated leaf once. A checkpoint holds the expert leaves as
DTensors ``Shard(0)`` over the expert dim and records ``expert_world``.

Pipeline parallelism (Queue 1 #7c): a model on a layout with a pipe axis
(:class:`tpudist_torch.models.gpt2.PipelinedGPT2`) holds its stage's
blocks and the replicated embeddings and head; every stage computes the
same loss. The module is not wrapped in DDP (its bucket all-reduces would
interleave with the schedule's point-to-point ops in the backward): the
step averages every gradient over the batch group (the ranks of this
rank's pipe and tensor indices) in one float32 all-reduce after the
schedule, and the optimizer clips and guards over the pipe group too
(a stage's block leaves counted on their stage alone). The params gather
the other stages' blocks (:func:`tpudist_torch.parallel.pp.
gather_stages`); a checkpoint holds a stage's blocks under their global
names on its ranks and records ``pipe_world``.

``fit`` raises ``NotImplementedError`` for every feature of the
reference's ``fit`` that is not ported yet, naming its ROADMAP item; none
is a silent no-op.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpudist_torch.amp import inner_state
from tpudist_torch.data.loader import prefetch_to_device
from tpudist_torch.distributed import group_up
from tpudist_torch.memory import device_memory_stats
from tpudist_torch.metrics import MetricsLogger
from tpudist_torch.models.lm_utils import seq_shard_lm
from tpudist_torch.optim import (
    FusedAdamWState, Optimizer, load_tensors, local)
from tpudist_torch.parallel import ep as ep_lib
from tpudist_torch.parallel import pp as pp_lib
from tpudist_torch.parallel import tp as tp_lib
from tpudist_torch.profiling import WindowedProfiler
from tpudist_torch.remat import remat_module, resolve as resolve_remat
from tpudist_torch.rng import fold_in


@dataclasses.dataclass
class TrainState:
    """``step``: optimizer steps taken; ``model``: the module (the
    forward's parameters and the BN running statistics); ``module``: what
    the step calls, ``DistributedDataParallel(model)`` under a process
    group and ``model`` otherwise; ``opt_state``: the optimizer's state."""

    step: int
    model: nn.Module
    module: nn.Module
    opt_state: object
    #: the explicit reducer's error-feedback residual ``[1, n_buckets,
    #: bucket_size]`` (this rank's), or None
    comm_residual: torch.Tensor | None = None
    #: the rank layout the state is placed on (its data DeviceMesh holds
    #: the residual and ZeRO-1's slices in a checkpoint), or None
    layout: object = None

    def _sharded(self) -> dict:
        """The sharded parameters by name: FSDP's DTensors, and the tensor
        shards as ``(parameter, mesh, placements, whole shape)``. FSDP2
        keeps its root's parameters gathered after a forward that no
        backward followed (an eval, a decode): they are sharded again
        first."""
        from torch.distributed.fsdp import FSDPModule

        for m in self.model.modules():
            if isinstance(m, FSDPModule):
                m.reshard()
        out = {k: p for k, p in self.model.named_parameters()
               if hasattr(p, "to_local")}
        layout = getattr(self.model, "layout", None)
        tensor = tp_lib.tensor_size(layout)
        expert = ep_lib.expert_size(layout)
        if tensor > 1 or expert > 1:
            from torch.distributed.tensor import Replicate, Shard

            mesh = layout.shard_mesh()
            names = mesh.mesh_dim_names
            table = self.model.tensor_specs
            vocab = getattr(self.model, "vocab_size", None)
            for k, p in self.model.named_parameters():
                spec = (tp_lib.tensor_spec(k, table=table) if tensor > 1
                        else None)
                on_expert = expert > 1 and ep_lib.is_expert_leaf(k)
                if spec is None and not on_expert:
                    continue
                # Shard on the tensor and expert dims that split the leaf,
                # replicated over the others (data, fsdp, seq; a stage's
                # leaves live on its ranks alone: the mesh has no pipe dim)
                place = [Replicate()] * mesh.ndim
                shape = list(p.shape)
                if spec is not None:
                    dim = 0 if spec[0] == "vocab" else spec[0]
                    place[names.index("tensor")] = Shard(dim)
                    shape = list(tp_lib.full_shape(k, p.shape, tensor, vocab,
                                                   table=table))
                if on_expert:
                    place[names.index("expert")] = Shard(0)
                    shape[0] *= expert
                out[k] = (p, mesh, place, tuple(shape))
        return out

    def _global(self, name: str, t: torch.Tensor, sharded: dict):
        """``t`` (this rank's shard of parameter ``name``'s leaf, or a
        state tensor of its shape) as a DTensor placed as the parameter.
        A tensor shard's DTensor is ``Shard`` of its split dim on the
        tensor mesh axis (``Replicate`` over data): exact for every leaf
        but GPT-2's ``qkv.weight``, whose grouped shards it stores in rank
        order (a checkpoint is bound to its ``tensor_world``)."""
        p = sharded.get(name)
        if isinstance(p, tuple):
            p, mesh, place, shape = p
            if hasattr(t, "to_local") or t.shape != p.shape:
                return t
            from torch.distributed.tensor import DTensor

            stride = torch.empty(shape, device="meta").stride()
            return DTensor.from_local(t, mesh, place, run_check=False,
                                      shape=shape, stride=stride)
        if p is None or hasattr(t, "to_local") or t.shape != local(p).shape:
            return t
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, p.device_mesh, p.placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride())

    def params(self) -> dict[str, torch.Tensor]:
        """The float32 master of every parameter, by name, whole: ZeRO-1's
        slices, FSDP's shards, the tensor shards and the other stages'
        blocks are gathered (every rank must call it then)."""
        opt = inner_state(self.opt_state)
        sharded = self._sharded()
        if hasattr(self.opt_state, "slices"):
            params = self.opt_state.full_masters()
        elif isinstance(opt, FusedAdamWState):
            params = opt.master
        else:
            params = dict(self.model.named_parameters())
        out = {}
        for k, p in params.items():
            p = p.detach()
            if not isinstance(sharded.get(k), tuple):
                # FSDP's shards (and ZeRO-1's slices of them) gathered
                p = whole_tensor(self._global(k, p, sharded))
            out[k] = p
        layout = getattr(self.model, "layout", None)
        if tp_lib.tensor_size(layout) > 1 or ep_lib.expert_size(layout) > 1:
            out = tp_lib.gather_state_dict(
                out, layout, getattr(self.model, "vocab_size", None),
                table=self.model.tensor_specs)
        if pp_lib.pipe_size(layout) > 1:
            out = pp_lib.gather_stages(out, layout)
        return out

    def batch_stats(self) -> dict[str, torch.Tensor]:
        """The BN running statistics, by buffer name."""
        return dict(self.model.named_buffers())

    def _own_params(self) -> dict[str, torch.Tensor]:
        # the parameters whose masters the optimizer state does not hold
        owned = getattr(inner_state(self.opt_state), "master", {})
        return {k: p.detach() for k, p in self.model.named_parameters()
                if k not in owned}

    def state_dict(self) -> dict:
        """What a checkpoint holds, as the live tensors (nothing copied):
        ``step``; ``params``, the parameters whose float32 masters the
        optimizer state does not hold (all of them but under the fused
        optimizer, whose state holds every master); ``buffers``, the BN
        running statistics and counters; ``opt``, the optimizer state's
        ``state_dict``; ``comm_residual`` when the reducer keeps one. Each
        tensor appears once, and a compute copy never (the fused optimizer
        derives it on load). A tensor that differs across ranks is a
        DTensor, so DCP writes one global array for it: FSDP's shards
        (and the optimizer state of their leaves), the tensor shards
        (likewise), ZeRO-1's slices, the residual (``Shard(0)`` of
        ``[world, n_buckets, bucket_size]``)."""
        sharded = self._sharded()

        def wrap(x):
            if isinstance(x, dict):
                return {k: (self._global(k, v, sharded)
                            if isinstance(v, torch.Tensor) else wrap(v))
                        for k, v in x.items()}
            return x

        sd = {"step": self.step, "params": wrap(self._own_params()),
              "buffers": self.batch_stats(),
              "opt": wrap(self.opt_state.state_dict())}
        if self.comm_residual is not None:
            sd["comm_residual"] = self._residual_dtensor()
        return sd

    def _residual_dtensor(self):
        mesh = self.layout.data_mesh() if self.layout is not None else None
        if mesh is None:
            return self.comm_residual
        from torch.distributed.tensor import DTensor, Shard

        r = self.comm_residual
        return DTensor.from_local(r, mesh, [Shard(0)], run_check=False,
                                  shape=(mesh.size(), *r.shape[1:]),
                                  stride=r.stride())

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy ``sd`` into the live tensors in place (no tensor is rebound:
        the fused kernel's table and DDP's buckets keep their storage) and
        take its step and counters."""
        def unwrap(x):
            if isinstance(x, dict):
                return {k: unwrap(v) for k, v in x.items()}
            return local(x)

        load_tensors({k: local(t) for k, t in self._own_params().items()},
                     unwrap(sd["params"]), "params")
        load_tensors(self.batch_stats(), sd["buffers"], "buffers")
        self.opt_state.load_state_dict(
            sd["opt"] if hasattr(self.opt_state, "slices")
            else unwrap(sd["opt"]))
        if self.comm_residual is not None and "comm_residual" in sd:
            load_tensors({"r": self.comm_residual},
                         {"r": local(sd["comm_residual"])}, "comm_residual")
        self.step = int(sd["step"])


def whole_tensor(t):
    """A DTensor's global value (every rank of its mesh calls it), any
    other tensor as it is. Each ``Shard`` placement (one a tensor dim, as
    FSDP's) is gathered with ``dist.all_gather`` over its mesh dim's
    group, the shards padded to the largest of ``torch.chunk``'s split,
    instead of ``full_tensor()``: its functional collectives crash over
    gloo on CUDA tensors (torch 2.11), which ranks sharing one card use."""
    if not hasattr(t, "to_local"):
        return t
    out = t.to_local().detach()
    mesh = t.device_mesh
    for i in range(mesh.ndim):
        dim = getattr(t.placements[i], "dim", None)
        if dim is None:
            continue
        group = mesh.get_group(i)
        n = dist.get_world_size(group)
        sizes = [len(c) for c in torch.arange(t.shape[dim]).chunk(n)]
        pad = max(sizes) - out.shape[dim]
        part = (F.pad(out.movedim(dim, -1), (0, pad)).movedim(-1, dim)
                if pad else out).contiguous()
        parts = [torch.empty_like(part) for _ in range(n)]
        dist.all_gather(parts, part, group=group)
        out = torch.cat([q.narrow(dim, 0, m) for q, m in zip(parts, sizes)],
                        dim)
    return out


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


def tp_lm_loss(logits, tokens, layout, vocab: int):
    """:func:`lm_loss` of vocabulary-local logits ``[B, S, V_local]``
    under a tensor axis (:func:`tpudist_torch.parallel.tp.
    vocab_parallel_cross_entropy`): the same mean on every tensor rank."""
    targets = torch.full_like(tokens, -100, dtype=torch.long)
    targets[:, :-1] = tokens[:, 1:]
    ce = tp_lib.vocab_parallel_cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1), layout,
        vocab)
    b, s = tokens.shape
    return ce.sum() / (b * (s - 1))


def create_train_state(model: nn.Module, tx: Optimizer, plan=None, *,
                       ddp: bool = True, layout=None) -> TrainState:
    """Build the optimizer state from ``model``'s parameters (the fused
    optimizer with a compute copy turns them into the copy here) and wrap
    the module in DDP when a process group is up. Every rank builds the
    model from the same seed; DDP's broadcast from rank 0 at wrap time is
    the reference's init-sync. ``plan`` with an ``fsdp`` axis shards the
    model with FSDP2 first (:func:`tpudist_torch.parallel.fsdp.
    apply_fsdp`; no DDP); ``ddp=False`` (the explicit reducer's path)
    broadcasts the parameters and buffers from rank 0 instead of
    wrapping. A model on a tensor layout (module docstring) is wrapped in
    DDP over the layout's data group, or not at all with one data
    replica, and ``tx`` clips and guards over the tensor group. A model
    on a pipe layout is not wrapped (the step averages its gradients
    over the batch group after the schedule) and ``tx`` clips and guards
    over the pipe group too. A model on an expert layout is wrapped in DDP
    over its batch group (the ranks that hold its experts) and ``tx``
    clips and guards over the expert group too."""
    module = model
    if plan is not None:
        layout = plan.layout
    tensor = tp_lib.tensor_size(getattr(model, "layout", None))
    pipe = pp_lib.pipe_size(getattr(model, "layout", None))
    expert = ep_lib.expert_size(getattr(model, "layout", None))
    if tensor > 1 or pipe > 1 or expert > 1:
        from tpudist_torch.parallel.fsdp import _base_optimizer

        layout = model.layout
        base = _base_optimizer(tx)
        if tensor > 1:
            base.shard_over(layout.tensor_group, tp_lib.sharded_names(model))
        if pipe > 1:
            base.shard_over(layout.pipe_group, pp_lib.stage_local_names(
                dict(model.named_parameters())))
        if expert > 1:
            base.shard_over(layout.expert_group, ep_lib.expert_names(model))
    if plan is not None and plan.wraps_fsdp:
        from tpudist_torch.parallel.fsdp import apply_fsdp

        apply_fsdp(model, plan.layout, tx, min_size=plan.fsdp_min_size)
    elif group_up() and not ddp:
        with torch.no_grad():
            for t in (*model.parameters(), *model.buffers()):
                dist.broadcast(t, 0)
    opt_state = tx.init(dict(model.named_parameters()))
    split = tensor > 1 or expert > 1
    if group_up() and ddp and not (plan is not None and plan.wraps_fsdp) \
            and not (split and layout.batch_group is None) \
            and pipe == 1:
        dev = next(model.parameters()).device
        module = nn.parallel.DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            broadcast_buffers=False,
            process_group=layout.batch_group if split else None)
    return TrainState(0, model, module, opt_state, layout=layout)


def _apply_input_transform(transform, inputs, batch, step=None):
    """The input_transform calling convention: plain transforms receive
    the inputs; transforms declaring ``wants_batch`` also receive the
    whole batch (the device cache's ``"_cache"`` rides there), and those
    declaring ``wants_step`` the step counter last. Eval paths pass
    ``step=None`` and refuse an augmenting (``wants_step``) transform."""
    if transform is None:
        return inputs
    wants_step = getattr(transform, "wants_step", False)
    if wants_step and step is None:
        raise ValueError(
            "input_transform declares wants_step (an augmenting transform) "
            "but this is an eval path — evaluate with the normalization "
            "transform only"
        )
    args = [inputs]
    if getattr(transform, "wants_batch", False):
        args.append(batch)
    if wants_step:
        args.append(step)
    return transform(*args)


def stream_rank(rank: int, layout) -> int:
    """The rank a dropout (and router-jitter) stream is keyed by: ``rank``
    without its tensor and expert indices, so the ranks of a tensor or
    expert group, which hold the same activations, draw the same masks."""
    tensor = tp_lib.tensor_size(layout)
    expert = ep_lib.expert_size(layout)
    r = rank // tensor
    if expert == 1:
        return r
    seq = layout.seq
    return (r // (seq * expert)) * seq + r % seq


def dropout_key(seed: int, rank: int, index: int) -> int:
    """The dropout stream's key for this rank's (micro)batch ``index``
    (the step, or ``step * grad_accum + microbatch``)."""
    return fold_in(seed, rank, index)


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


def make_train_step(model, tx: Optimizer, *, loss_fn: Callable = cross_entropy_loss,
                    input_key: str = "image", label_key: str = "label",
                    fused=None, grad_accum: int = 1, reduce="none",
                    forward_loss: Callable | None = None, remat=False,
                    dropout_seed: int = 0,
                    input_transform: Callable | None = None, layout=None,
                    plan=None, reduce_bucket_size: int | None = None):
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
    fused optimizer's compute copy.

    ``forward_loss(module, batch) -> loss`` takes the place of
    ``loss_fn(module(batch[input_key]), batch[label_key])`` for every
    (micro)batch, as the reference's ``forward_loss=`` does. ``fused="ln"``
    sets the model's ``fused_ln`` attribute, which a ``forward_loss``
    built on the same model reads at each call: the reference's
    ``rebuild`` hook (which re-closes a loss over a fused clone) has no
    counterpart here because nothing is cloned.

    ``input_transform`` applies to ``batch[input_key]`` before the model
    (never to the labels), with the step (or the microbatch's index under
    ``grad_accum``) for a transform that wants it; a ``forward_loss``
    reads the batch itself, as in the reference. ``remat`` names a policy
    of :mod:`tpudist_torch.remat` for the model's whole forward.
    ``dropout_seed`` keys the dropout stream of a model with ``dropout >
    0`` (module docstring); such a model refuses a ``forward_loss``, which
    has no stream, as the reference does.

    ``layout`` shards the sequence over its seq group (module docstring):
    the model must be one built on the same layout (a context-parallel
    ``attn_impl``, or another, which attends over the gathered sequence),
    the default loss must be ``lm_loss`` on ``"tokens"``, and a
    ``forward_loss`` must be one built for the same layout
    (``chunked_lm_forward(..., layout=)``).

    ``reduce`` (``"none"``, ``"bucketed"``, ``"quantized"``, ``"auto"``
    or a built :class:`~tpudist_torch.parallel.dp.GradReducer`) takes the
    explicit reducer's path (module docstring; ``step.grad_reducer`` is
    None on DDP's); ``reduce_bucket_size`` sets its buckets' elements.
    The state must then be built with
    ``create_train_state(..., ddp=False)`` and carry the residual
    (``step.grad_reducer.new_residual``); ``fit`` does both.
    ``plan`` (a :class:`~tpudist_torch.parallel.plan.ParallelPlan`)
    validates the reducer against its axes and, with ``fsdp > 1``,
    expects a state built under it (FSDP's module): the step then
    all-reduces the gradients of the leaves FSDP leaves replicated.
    ``step.comm_stats(params)`` is the reducer's wire accounting (None
    without one), ``step.plan`` the plan.

    Under a process group ``step(state, batch, votes)`` also sums the
    host floats ``votes`` over the ranks in the loss's all-reduce
    (``metrics["votes"]``, on the device): ``fit`` agrees its stop and
    save decisions through them without a collective of their own."""
    from tpudist_torch.allreduce import DEFAULT_BUCKET_ELEMS
    from tpudist_torch.parallel.dp import make_reducer

    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if plan is not None:
        plan.validate_reduce(reduce)
        if layout is None:
            layout = plan.layout
    tensor = tp_lib.tensor_size(getattr(model, "layout", None))
    pipe = pp_lib.pipe_size(getattr(model, "layout", None))
    expert = ep_lib.expert_size(getattr(model, "layout", None))
    # a causal LM under a tensor axis: the vocabulary-local LM loss
    lm_tensor = tensor > 1 and getattr(model, "causal_lm", False)
    if pipe > 1:
        from tpudist_torch.mesh import PIPE_REMAINDER

        if resolve_remat(remat) is not None:
            raise NotImplementedError(
                "remat over a pipelined model is not ported yet (ROADMAP "
                f"{PIPE_REMAINDER})")
        if forward_loss is not None:
            raise ValueError("a pipelined model trains on the default LM "
                             "loss (the reference refuses --chunked_ce "
                             "with --pipe)")
    if tensor > 1 or pipe > 1 or expert > 1:
        from tpudist_torch.parallel.plan import ParallelPlan

        if layout is not None and layout is not model.layout:
            raise ValueError("a tensor-parallel, expert-parallel or "
                             "pipelined model trains on its own layout: "
                             "pass make_train_step(layout=model.layout) or "
                             "none")
        layout = model.layout
        # the explicit reducer reduces over data alone: the plan's refusal
        ParallelPlan(layout).validate_reduce(reduce)
        if forward_loss is None and lm_tensor and (
                loss_fn is not lm_loss or input_key != label_key):
            raise ValueError("a tensor-parallel step computes the next-token "
                             "loss of its tokens on the vocabulary-local "
                             "logits: pass loss_fn=lm_loss")
    reducer = None
    if reduce not in (None, "none"):
        reducer = make_reducer(
            reduce, layout if layout is not None else default_layout(),
            bucket_size=reduce_bucket_size or DEFAULT_BUCKET_ELEMS)
    fsdp = plan is not None and plan.wraps_fsdp
    fused_set = resolve_fused(fused, model, tx)
    if "optimizer" not in fused_set and getattr(tx, "compute_dtype", None):
        raise ValueError(
            "a fused_adamw with a compute copy feeds the forward from the "
            "copy; build the step with fused='optimizer' (or 'auto')")

    dropout_rate = float(getattr(model, "dropout", 0.0) or 0.0)
    jitter_rate = float(getattr(model, "router_jitter", 0.0) or 0.0)
    if forward_loss is not None and dropout_rate > 0:
        raise ValueError(
            f"model.dropout={dropout_rate} but forward_loss has no rng "
            "stream; use the default forward or a dropout-free model")
    if forward_loss is not None and jitter_rate > 0:
        raise ValueError(
            f"model.router_jitter={jitter_rate} but forward_loss has "
            "no rng stream; use the default forward or router_jitter=0")
    # the MoE layers' aux losses of the forward join the task loss (a
    # forward_loss adds them itself)
    aux = ((lambda: ep_lib.moe_losses(model))
           if getattr(model, "has_aux_loss", False) else (lambda: 0.0))
    if resolve_remat(remat) is not None and next(model.buffers(), None) is not None:
        raise ValueError(
            "remat recomputes the forward, and this model updates buffers in "
            "it (BatchNorm's running statistics would move twice a step)")
    seq = layout.seq if layout is not None else 1
    if seq > 1:
        if getattr(model, "layout", None) is not layout:
            raise ValueError(
                f"a seq axis of {seq} needs a model built on the same layout "
                "(its attention runs over the layout's seq group)")
        if forward_loss is None and (loss_fn is not lm_loss
                                     or input_key != label_key):
            raise ValueError("a seq-sharded step computes the next-token "
                             "loss of its tokens: pass loss_fn=lm_loss")
        if forward_loss is not None and getattr(
                forward_loss, "layout", None) is not layout:
            raise ValueError("forward_loss does not shard the sequence over "
                             "this layout; build it with chunked_lm_forward("
                             "..., layout=layout)")
    remat_module(model, remat)

    if "ln" in fused_set:
        # the reference's clone with fused_ln=True: the same parameters,
        # the LayerNorms through the fused kernel
        model.fused_ln = True

    if reducer is not None:
        # the DDP default: each replica's batch statistics, the running
        # averages averaged over the replicas after the step
        for m in model.modules():
            if hasattr(m, "cross_replica"):
                m.cross_replica = False
    # dropout masks (and router jitter) keyed by the rank without its
    # tensor and expert indices (the replica, and its seq index under a
    # seq axis): its tensor and expert ranks hold the same activations and
    # must drop the same elements
    rank = stream_rank(dist.get_rank() if group_up() else 0, layout)
    keyed = dropout_rate > 0 or jitter_rate > 0
    if forward_loss is None and lm_tensor:
        def run_loss(module, batch, index):
            tokens = batch[input_key].long()
            kw = ({"dropout_key": dropout_key(dropout_seed, rank, index)}
                  if keyed else {})
            if seq == 1:
                logits = module(tokens, vocab_local=True, **kw)
                return (tp_lm_loss(logits, tokens, layout, model.vocab_size)
                        + aux())
            # this rank's chunk, scored on its vocabulary columns: the CE
            # sum over the replica's positions, as under seq alone
            local, labels = seq_shard_lm(tokens, layout)
            logits = module(local, vocab_local=True, **kw)
            ce = tp_lib.vocab_parallel_cross_entropy(
                logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                layout, model.vocab_size)
            b, s = tokens.shape
            return ce.sum() / (b * (s - 1))
    elif forward_loss is None and seq > 1:
        def run_loss(module, batch, index):
            tokens = batch[input_key].long()
            local, labels = seq_shard_lm(tokens, layout)
            kw = ({"dropout_key": dropout_key(dropout_seed, rank, index)}
                  if keyed else {})
            logits = module(local, **kw)
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                                 labels.reshape(-1), ignore_index=-100,
                                 reduction="sum")
            b, s = tokens.shape
            return ce / (b * (s - 1))
    elif forward_loss is None:
        def run_loss(module, batch, index):
            inputs = _apply_input_transform(input_transform, batch[input_key],
                                            batch, index)
            kw = ({"dropout_key": dropout_key(dropout_seed, rank, index)}
                  if keyed else {})
            return loss_fn(module(inputs, **kw), batch[label_key]) + aux()
    else:
        def run_loss(module, batch, index):
            return forward_loss(module, batch)

    def accumulate(state, batch, params):
        # "_"-prefixed keys are per-step operands (the device cache), not
        # rows: every microbatch reads them whole
        operands = {k: v for k, v in batch.items() if k.startswith("_")}
        micro = {k: v.reshape(grad_accum, -1, *v.shape[1:])
                 for k, v in batch.items() if k not in operands}
        sums = {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}
        lsum = torch.zeros((), dtype=torch.float32,
                           device=next(iter(sums.values())).device)
        ddp = isinstance(state.module, nn.parallel.DistributedDataParallel)
        with state.module.no_sync() if ddp else contextlib.nullcontext():
            for i in range(grad_accum):
                loss = run_loss(state.module,
                                {**{k: v[i] for k, v in micro.items()},
                                 **operands},
                                state.step * grad_accum + i)
                backward(loss)
                for k, p in params.items():
                    if p.grad is not None:
                        sums[k] += p.grad
                        p.grad = None
                lsum += loss.detach()
        if group_up():
            # FSDP reduced its shards in each backward: the rest here
            sums = {**sums, **average_replicated(
                {k: t for k, t in sums.items() if not hasattr(t, "to_local")},
                group=avg_group)}
        return lsum / grad_accum, {k: t / grad_accum for k, t in sums.items()}

    # under a tensor or pipe axis gradients are averaged over the ranks
    # with this rank's tensor and pipe indices alone (a shard or a stage
    # differs from its peers'); False: no other such rank
    avg_group = ((layout.batch_group if layout.batch_group is not None
                  else False) if tensor > 1 or pipe > 1 or expert > 1
                 else None)

    def backward(loss):
        # DDP averages over data x seq ranks; the chunks' gradients add
        (loss * seq if seq > 1 else loss).backward()

    def micro_batch(batch, i):
        operands = {k: v for k, v in batch.items() if k.startswith("_")}
        return {**{k: v.reshape(grad_accum, -1, *v.shape[1:])[i]
                   for k, v in batch.items() if k not in operands},
                **operands}

    def reduced(state, batch, params):
        # the explicit reducer: local gradients, flattened and reduced
        def grad_fn(i):
            mb = batch if grad_accum == 1 else micro_batch(batch, i)
            loss = run_loss(state.module, mb, state.step * grad_accum + i
                            if grad_accum > 1 else state.step)
            loss.backward()
            g = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
            for p in params.values():
                p.grad = None
            return loss.detach(), g

        loss, grads, state.comm_residual = reducer.compute(
            grad_fn, list(params), grad_accum, state.step,
            state.comm_residual)
        average_stats(state.model)
        # the buckets hold each leaf in its logical order; a gradient takes
        # its parameter's layout back (the fused AdamW reads both in one
        # layout, and a ResNet's conv weights are channels-last on the card)
        return loss, {k: g if g.stride() == params[k].stride() else
                      torch.empty_like(params[k], dtype=g.dtype).copy_(g)
                      for k, g in grads.items()}

    def average_stats(model):
        w = torch.full((), float(reducer.world))
        with torch.no_grad():
            for m in model.modules():
                if hasattr(m, "cross_replica"):
                    for b in (m.mean, m.var):
                        t = reducer.ring.all_reduce_sum(b[None])[0]
                        b.copy_(t / w.to(t.device))

    def step(state: TrainState, batch: dict, votes: tuple = ()):
        state.module.train()
        params = dict(state.model.named_parameters())
        for p in params.values():
            p.grad = None
        if reducer is not None:
            loss, grads = reduced(state, batch, params)
        elif grad_accum == 1:
            loss = run_loss(state.module, batch, state.step)
            backward(loss)
            grads = {k: p.grad for k, p in params.items()}
            if fsdp or pipe > 1:
                grads.update(average_replicated(
                    {k: g for k, g in grads.items()
                     if g is not None and not hasattr(g, "to_local")},
                    group=avg_group))
        else:
            loss, grads = accumulate(state, batch, params)
        tx.step(state.opt_state, params, grads)
        state.step += 1
        loss = loss.detach()
        if not group_up():
            return state, {"loss": loss}
        # the global-batch mean, as the reference's loss is (replicas hold
        # equal batches, a seq group's chunks add up to its replica's
        # mean); a SUM, because gloo has no AVG. The votes ride the same
        # all-reduce and come back summed over the ranks.
        flat = torch.cat([loss.reshape(1).float(),
                          *(loss.new_full((1,), float(v), dtype=torch.float32)
                            for v in votes)])
        dist.all_reduce(flat)
        metrics = {"loss": flat[0] / (dist.get_world_size() // seq)}
        if votes:
            metrics["votes"] = flat[1:]
        return state, metrics

    step.fused = fused_set
    step.grad_reducer = reducer
    step.plan = plan
    step.comm_stats = (
        (lambda params: reducer.comm_stats(params, grad_accum))
        if reducer is not None else (lambda params: None))
    return step


def default_layout():
    """The data-only layout of the formed world (no group is created: the
    data group is the default group, its DeviceMesh wraps it)."""
    from tpudist_torch.mesh import DATA_AXIS, RankLayout

    if not group_up() or dist.get_world_size() == 1:
        return RankLayout(0, 1, 1)
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh.from_group(
        dist.group.WORLD, "cuda" if dist.get_backend() == "nccl" else "cpu",
        mesh_dim_names=(DATA_AXIS,))
    return RankLayout(dist.get_rank(), dist.get_world_size(), 1,
                      data_group=dist.group.WORLD, device_mesh=mesh)


def average_replicated(grads: dict, group=None) -> dict:
    """The mean over every rank (of ``group``; ``False``: no other rank)
    of each gradient in ``grads``, in one float32 all-reduce (the leaves
    DDP does not see: the accumulated sums under ``grad_accum``, the
    replicated leaves FSDP ignores)."""
    if not grads or not group_up() or group is False:
        return grads
    flat = torch.cat([t.reshape(-1).float() for t in grads.values()])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    parts = flat.split([t.numel() for t in grads.values()])
    return {k: p.view_as(t).to(t.dtype)
            for (k, t), p in zip(grads.items(), parts)}


class _DelayedFetch:
    """One-step-delayed fetch of a step's scalars: :meth:`start` copies the
    loss (and the summed votes, when the step returns them) into one of
    two pinned host buffers behind an event; :meth:`value` waits for that
    event only, after the next step is dispatched, and returns
    ``(loss, votes)``."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.bufs = [None, None]
        self.turn = 0

    def start(self, metrics: dict):
        values = metrics["loss"].reshape(1)
        if "votes" in metrics:
            values = torch.cat([values, metrics["votes"]])
        buf = self.bufs[self.turn]
        if buf is None or buf.shape != values.shape:
            buf = torch.empty(values.shape, dtype=torch.float32,
                              pin_memory=self.cuda)
            self.bufs[self.turn] = buf
        self.turn ^= 1
        buf.copy_(values, non_blocking=True)
        ready = None
        if self.cuda:
            ready = torch.cuda.Event()
            ready.record()
        return buf, ready

    @staticmethod
    def value(handle) -> tuple[float, list[float]]:
        buf, ready = handle
        if ready is not None:
            ready.synchronize()
        values = buf.tolist()
        return values[0], values[1:]


_DEFERRED = {
    # fit() keyword: (value meaning "off", ROADMAP item)
    "telemetry": (False, "Queue 1 #8"),
    "metrics_port": (None, "Queue 1 #8"),
    "repair": (None, "Queue 1 #8"),
    "compile_cache": (None, "Queue 1 #9"),
}


def run_geometry(train_loader, *, batch_size: int, world_size: int,
                 grad_accum: int, model=None, fsdp_world: int = 1,
                 reduce: str | None = None, shard_opt_state: bool = False,
                 data_world: int | None = None,
                 tensor_world: int = 1, pipe_world: int = 1,
                 expert_world: int = 1) -> dict:
    """The geometry a checkpoint is bound to (``tpudist_meta.json``, the
    reference's keys): the data position of ``state.step`` depends on
    each of them. ``fsdp_world`` is the plan's, ``tensor_world`` and
    ``pipe_world`` the layout's;
    ``reduce`` (the explicit reducer's method) and ``shard_opt_state``
    are recorded only when on, with ``data_world``, the world their
    stored layouts are bound to. A language model's ``geometry`` (its arch
    and widths: GPT-2's heads, Llama's K/V heads, SwiGLU width, theta and
    tying) goes in under ``"model"``, so a resume into another geometry is
    refused by the same guard before any tensor is read."""
    if not hasattr(train_loader, "__len__"):
        raise ValueError(
            "checkpointing needs a sized train_loader (len() maps state.step "
            "to an epoch/batch position for exact resume)")
    meta = {"steps_per_epoch": len(train_loader), "batch_size": batch_size,
            "world_size": world_size, "grad_accum": grad_accum,
            "fsdp_world": int(fsdp_world), "tensor_world": int(tensor_world),
            "pipe_world": int(pipe_world)}
    if expert_world > 1:
        meta["expert_world"] = int(expert_world)
    if shard_opt_state:
        meta["shard_opt_state"] = True
    if reduce is not None:
        meta["reduce"] = reduce
    if shard_opt_state or reduce is not None:
        meta["data_world"] = int(data_world if data_world is not None
                                 else world_size)
    geometry = getattr(model, "geometry", None)
    if geometry is not None:
        meta["model"] = dict(geometry)
    return meta


def _bring_up_checkpoint(ckpt, state, run_meta: dict, *, resume: bool,
                         checkpoint_dir, elastic: bool = False) -> int:
    """Resume from ``ckpt``'s newest loadable step into ``state`` (in
    place) when it holds one, after the geometry guard; record this run's
    geometry. A pure world resize is resharded under ``elastic``
    (:func:`tpudist_torch.resilience.elastic.reshard_restore`) and
    committed: the old steps quarantined, the new-world state saved, the
    meta flipped, the quarantine purged. Returns the step the run starts
    from."""
    from tpudist_torch.resilience import elastic as elastic_mod

    # finish or roll back a reshard commit a previous life left half done
    ckpt.recover_interrupted_reshard()
    start_step = 0
    resharded = False
    if ckpt.latest_step() is not None:
        if not resume:
            raise ValueError(
                f"checkpoint_dir {checkpoint_dir} already holds checkpoints "
                "but resume=False; refusing to mix runs (the old steps + "
                "overwritten meta would corrupt a later resume) — use a fresh "
                "checkpoint_dir")
        saved = ckpt.read_meta()
        if saved is not None and not elastic_mod.meta_matches(saved, run_meta):
            reason = elastic_mod.refusal_reason(saved, run_meta)
            if not elastic or reason is not None:
                hint = (" — this is a pure world resize; pass "
                        "fit(elastic=True) to reshard onto the live layout"
                        if reason is None else f" — {reason}")
                raise ValueError(
                    f"checkpoint at {checkpoint_dir} was written by a run "
                    f"with different geometry ({saved} != {run_meta}); "
                    "state.step would map to the wrong data position — "
                    "resume with the original settings or start a fresh "
                    f"checkpoint_dir{hint}")
            if run_meta.get("expert_world", 1) > 1:
                from tpudist_torch.mesh import EXPERT_REMAINDER

                raise NotImplementedError(
                    "an elastic data resize of a checkpoint written under "
                    "an expert axis is not ported yet (ROADMAP "
                    f"{EXPERT_REMAINDER})")
            resharded = True
        events: list[dict] = []
        if resharded:
            elastic_mod.reshard_restore(
                ckpt, state, ckpt.latest_step(), saved_meta=saved,
                run_meta=run_meta, on_event=events.append)
        else:
            ckpt.restore(state, fallback=True, on_event=events.append)
        for ev in events:
            tag = ev.get("tag", "checkpoint_fallback")
            print(f"{tag}: {json.dumps(ev)}", flush=True)
            if tag == "checkpoint_fallback":
                # set aside what failed to load: it would shadow
                # latest_step and take the step number a later save needs
                ckpt.quarantine_failed_step(ev["failed_step"])
        start_step = state.step
        if resharded:
            ckpt.quarantine_steps(commit_meta=run_meta)
            ckpt.save(state, wait=True)
    ckpt.write_meta(run_meta)
    ckpt.purge_quarantined()
    return start_step


def fit(model: nn.Module, tx: Optimizer, train_loader, *, epochs: int,
        job_id: str = "Job0", batch_size: int | None = None,
        world_size: int | None = None, global_rank: int | None = None,
        loss_fn: Callable = cross_entropy_loss, input_key: str = "image",
        label_key: str = "label", fused=None, grad_accum: int = 1,
        forward_loss: Callable | None = None, remat=False, seed: int = 0,
        input_transform: Callable | None = None,
        profile: bool = True, prefetch_depth: int = 2, log_dir: str = ".",
        metrics_logger: MetricsLogger | None = None,
        memory_log_every: int | None = None,
        checkpoint_dir: str | None = None, checkpoint_every: int = 0,
        checkpoint_every_s: float | None = None,
        keep_last: int | None = None, resume: bool = True,
        preempt: bool | str = "auto", chaos=None, layout=None,
        reduce="none", plan=None, shard_opt_state: bool = False,
        elastic: bool = False, reduce_bucket_size: int | None = None,
        **deferred):
    """The reference's training program as a function: epochs x batches,
    the per-epoch sampler re-shuffle, the windowed profiler, the TSV
    metrics and the TrainTime footer. ``model`` carries its initial
    weights (built from a seed on every rank) and its device; the loader
    yields host batches of numpy arrays. Returns ``(state, losses)``, the
    per-step losses of this run in step order. With ``grad_accum > 1``
    each loader batch holds ``grad_accum`` microbatches, and
    ``forward_loss`` replaces the default loss and ``layout`` shards the
    sequence over its seq group (see :func:`make_train_step`).

    Persistence and recovery, as the reference's ``fit``:

    - ``checkpoint_dir`` saves the state (:mod:`tpudist_torch.checkpoint`)
      every ``checkpoint_every`` steps and/or every ``checkpoint_every_s``
      seconds of wall clock (every save resets the clock; the step cadence
      stays on its multiples), and once at the end; ``keep_last`` bounds
      retention. With ``resume`` (the default) the newest loadable step is
      restored into the freshly built state (after the geometry guard:
      a checkpoint of another ``steps_per_epoch``, batch size, world or
      ``grad_accum`` is refused) and training continues at the next step:
      the same epoch, the same position in the sampler's order, through
      the loader's ``iter_from``. ``resume=False`` refuses a directory
      that holds checkpoints. A newest step that fails to load is
      reported (a ``checkpoint_fallback`` line), set aside under
      ``_failed/`` and the previous one restored.
    - ``preempt`` (``"auto"``) traps SIGTERM/SIGINT as a flag checked at
      step boundaries; on a trip the in-flight step finishes, the
      checkpoint at the last completed step is written synchronously and
      :class:`tpudist_torch.resilience.Preempted` (exit 75) is raised,
      carrying the state and the losses. ``False`` keeps the default
      dispositions.
    - ``chaos`` injects a fault at a step boundary
      (:mod:`tpudist_torch.resilience.chaos`).

    One rank stops at the boundary where its flag is set, so
    ``sigterm@k`` persists step k. Under a process group the ranks must
    stop (and save) at the same step, or one would wait in a collective
    for ever: each step's all-reduce carries the rank's stop vote (and
    its vote that the save clock is due), read a step late with the loss,
    so every rank takes the decision at the same boundary, one or two
    steps after the first flag, with no host sync of its own. A stalled
    input ends early on a trip only on one rank.

    The delayed loss fetch and the ``--amp`` flag are resolved before a
    save (a wait at save steps only), so the saved counters are exact.

    ``memory_log_every`` cadences the TSV's ``HBM`` rows
    (:meth:`MetricsLogger.log_memory`): one after bring-up, then every N
    steps, each carrying the interval's peak (the allocator's peak when
    it rose since the last row, else the bytes in use). ``None`` is
    ``log_every * 10`` on the card and off on the CPU, whose allocator
    reports nothing; 0 is off.

    The data-parallel layers: ``reduce`` names the explicit reducer
    (:func:`make_train_step`; its residual is attached here), ``plan`` a
    :class:`~tpudist_torch.parallel.plan.ParallelPlan` (FSDP over ``data
    x fsdp``), ``shard_opt_state`` ZeRO-1 (through ``plan.wrap_zero1``
    under a plan), and ``elastic`` lets a resume reshard a checkpoint
    written at another data world (the geometry's world-shaped keys may
    differ, its semantic ones, ``reduce`` and ``shard_opt_state``, may
    not).

    The reference's other keywords (``telemetry``, ``metrics_port``,
    ``repair``, ``compile_cache``) are accepted and raise
    ``NotImplementedError`` naming their ROADMAP item unless they are at
    their "off" value."""
    from tpudist_torch.resilience import PreemptionGuard, Preempted, make_injector

    for key, value in deferred.items():
        if key not in _DEFERRED:
            raise TypeError(f"fit() got an unexpected keyword argument {key!r}")
        off, item = _DEFERRED[key]
        if value != off:
            raise NotImplementedError(
                f"fit({key}={value!r}) is not ported yet (ROADMAP {item})")
    device = next(model.parameters()).device
    if world_size is None:
        world_size = dist.get_world_size() if group_up() else 1
    if global_rank is None:
        global_rank = dist.get_rank() if group_up() else 0
    if batch_size is None:
        batch_size = train_loader.batch_size
    if hasattr(train_loader, "probe"):
        # the reference draws a one-row probe batch before training (its
        # shape source); drawn here too, so a host transform's stream (the
        # host augmentation) stands where the reference's does
        train_loader.probe()
    if plan is not None and layout is None:
        layout = plan.layout
    if pp_lib.pipe_size(getattr(model, "layout", None)) > 1 and (
            shard_opt_state or elastic):
        from tpudist_torch.mesh import PIPE_REMAINDER

        raise NotImplementedError(
            "ZeRO-1 and the elastic resume over a pipelined model are not "
            f"ported yet (ROADMAP {PIPE_REMAINDER})")
    if shard_opt_state:
        from tpudist_torch.optim import shard_state

        tx = (plan.wrap_zero1(tx) if plan is not None else
              shard_state(tx, layout if layout is not None
                          else default_layout()))
    step = make_train_step(model, tx, loss_fn=loss_fn, input_key=input_key,
                           label_key=label_key, fused=fused,
                           grad_accum=grad_accum, forward_loss=forward_loss,
                           remat=remat, dropout_seed=seed,
                           input_transform=input_transform, layout=layout,
                           reduce=reduce, plan=plan,
                           reduce_bucket_size=reduce_bucket_size)
    reducer = step.grad_reducer
    state = create_train_state(
        model, tx, plan, ddp=reducer is None,
        layout=layout if layout is not None else default_layout())
    if reducer is not None:
        state.comm_residual = reducer.new_residual(
            dict(model.named_parameters()))
        if global_rank == 0:
            # one step's wire accounting, as the reference's comm row has it
            print("grad_reducer: " + json.dumps(
                step.comm_stats(dict(model.named_parameters()))), flush=True)
    data_world = (layout.data if layout is not None else world_size)
    run_meta = (run_geometry(
        train_loader, batch_size=batch_size, world_size=world_size,
        grad_accum=grad_accum, model=model,
        fsdp_world=plan.fsdp if plan is not None else 1,
        reduce=reducer.method if reducer is not None else None,
        shard_opt_state=shard_opt_state, data_world=data_world,
        tensor_world=tp_lib.tensor_size(getattr(model, "layout", None)),
        pipe_world=pp_lib.pipe_size(getattr(model, "layout", None)),
        expert_world=ep_lib.expert_size(getattr(model, "layout", None)))
        if checkpoint_dir is not None else None)
    chaos_inj = make_injector(chaos)
    # ranks agree their stop and time-cadence saves through the step's
    # all-reduce; one rank decides on its own, at once
    voting = group_up() and dist.get_world_size() > 1
    fetch = _DelayedFetch(device)
    losses: list[float] = []
    logger = metrics_logger or MetricsLogger(
        job_id, batch_size, global_rank, world_size, log_dir=log_dir)
    # installed before the checkpoint bring-up: a preemption anywhere past
    # here exits 75 after persisting what had become restorable
    guard = PreemptionGuard(enabled=bool(preempt)).__enter__()
    ckpt = None
    start_step = global_step = 0
    preempt_signum = None
    try:
        if checkpoint_dir is not None:
            from tpudist_torch.checkpoint import Checkpointer

            ckpt = Checkpointer(checkpoint_dir, keep_last=keep_last)
            if chaos_inj is not None:
                # the corrupt drill truncates a committed step: settle the
                # save in flight first
                chaos_inj.bind(checkpoint_dir, wait=ckpt.wait)
            start_step = global_step = _bring_up_checkpoint(
                ckpt, state, run_meta, resume=resume,
                checkpoint_dir=checkpoint_dir, elastic=elastic)
        steps_per_epoch = len(train_loader) if run_meta else None
        with logger, WindowedProfiler(job_id, enabled=profile,
                                      log_dir=f"{log_dir}/log_{job_id}",
                                      device=device) as prof:
            print("Start")
            # the live memory after bring-up (parameters and optimizer
            # state placed, no activations yet); None on the CPU
            mem_stats = device_memory_stats(device)
            logger.log_memory(mem_stats)
            mem_every = memory_log_every
            if mem_every is None:
                mem_every = logger.log_every * 10 if mem_stats else 0
            mem_peak = {"seen": (mem_stats or {}).get("peak_bytes_in_use")}

            def log_memory() -> None:
                m = device_memory_stats(device)
                interval_peak = None
                if m:
                    lp = m.get("peak_bytes_in_use")
                    if lp is not None and (mem_peak["seen"] is None
                                           or lp > mem_peak["seen"]):
                        interval_peak = mem_peak["seen"] = lp
                    else:
                        interval_peak = m.get("bytes_in_use")
                logger.log_memory(m, peak_bytes_in_use=interval_peak)

            pending = None  # (global_step, epoch, idx, start, handle)
            agreed = {"stop": False, "save": False}
            last_save = {"t": time.monotonic(), "step": start_step}

            def resolve(now: float) -> None:
                g, e, idx, start, handle = pending
                loss_value, votes = fetch.value(handle)
                losses.append(loss_value)
                logger.log_step(g, loss_value, now - start)
                logger.print_progress(e, idx, loss_value)
                if votes:
                    agreed["stop"] = agreed["stop"] or votes[0] > 0
                    # a vote cast before the last save is spent
                    agreed["save"] = agreed["save"] or (
                        votes[1] > 0 and g > last_save["step"])

            def save_due(g: int) -> bool:
                if checkpoint_every and g % checkpoint_every == 0:
                    return True
                if voting:
                    return agreed["save"]
                return bool(checkpoint_every_s) and (
                    time.monotonic() - last_save["t"] >= checkpoint_every_s)

            # a trip while the consumer waits on a stalled input ends the
            # stream early; under a group only a vote may stop a rank
            stop_check = ((lambda: guard.tripped is not None)
                          if guard.active and not voting else None)
            logger.start_timer()
            try:
                start_epoch = global_step // steps_per_epoch if run_meta else 0
                skip = global_step % steps_per_epoch if run_meta else 0
                for e in range(start_epoch, epochs):
                    if hasattr(train_loader, "sampler"):
                        train_loader.sampler.set_epoch(e)
                    first_idx = skip if e == start_epoch else 0
                    batches = (train_loader.iter_from(first_idx) if first_idx
                               else iter(train_loader))
                    if chaos_inj is not None:
                        batches = chaos_inj.wrap_batches(batches,
                                                         global_step + 1)
                    staged = prefetch_to_device(batches, device,
                                                depth=prefetch_depth,
                                                stop_check=stop_check)
                    for idx, batch in enumerate(staged, start=first_idx):
                        # the step boundary, before the next dispatch: chaos
                        # first (an injected SIGTERM is seen below at once),
                        # then the stop decision, so the checkpoint the
                        # emergency save writes is the last completed step
                        if chaos_inj is not None:
                            chaos_inj.maybe_fire(global_step)
                        tripped = guard.tripped is not None
                        if agreed["stop"] or (tripped and not voting):
                            preempt_signum = guard.tripped
                            break
                        start = time.time()
                        global_step += 1
                        votes = ()
                        if voting:
                            votes = (float(tripped), float(
                                bool(checkpoint_every_s) and time.monotonic()
                                - last_save["t"] >= checkpoint_every_s))
                        state, metrics = step(state, batch, votes)
                        handle = fetch.start(metrics)
                        prof.step()
                        if pending is not None:
                            resolve(start)
                        pending = (global_step, e, idx, start, handle)
                        if mem_every and global_step % mem_every == 0:
                            log_memory()
                        if ckpt is not None and save_due(global_step):
                            # resolve the step first: its loss row, and the
                            # votes it carries, are then taken on every rank
                            # at this same save
                            resolve(time.time())
                            pending = None
                            ckpt.save(state)
                            agreed["save"] = False
                            last_save.update(t=time.monotonic(),
                                             step=global_step)
                    # a trip during a stalled input wait ends the stream
                    # without the check above
                    if not voting and guard.tripped is not None:
                        preempt_signum = guard.tripped
                    if agreed["stop"] or preempt_signum is not None:
                        break
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
            preempted = preempt_signum is not None or agreed["stop"]
            if ckpt is not None and global_step > start_step:
                # the emergency save is synchronous: the supervisor may
                # relaunch the moment this process exits
                ckpt.save(state, wait=preempted)
    finally:
        guard.__exit__(None, None, None)
        if ckpt is not None:
            ckpt.close()
    if preempted:
        raise Preempted(preempt_signum, global_step, state=state,
                        losses=losses)
    return state, losses


@torch.no_grad()
def evaluate(state: TrainState, loader, *, input_key: str = "image",
             label_key: str = "label",
             input_transform: Callable | None = None) -> float:
    """Top-1 accuracy of ``state.model`` (running BN statistics) over every
    sample of ``loader``. Under a process group the hit and row counts are
    summed over the ranks, so each rank may hold the full validation set
    (the reference's convention) or its own shard. ``input_transform`` is
    :func:`make_train_step`'s hook, without a step."""
    model = state.model
    model.eval()
    device = next(model.parameters()).device
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    for batch in prefetch_to_device(iter(loader), device):
        logits = model(_apply_input_transform(input_transform,
                                              batch[input_key], batch))
        labels = batch[label_key].long()
        counts[0] += (logits.argmax(-1) == labels).sum()
        counts[1] += labels.numel()
    if group_up():
        dist.all_reduce(counts)
    hits, total = counts.tolist()
    return hits / max(total, 1)


@torch.no_grad()
def evaluate_lm(state: TrainState, loader, *, input_key: str = "tokens",
                chunk: int | None = None,
                input_transform: Callable | None = None) -> dict[str, float]:
    """Next-token cross-entropy and perplexity of ``state.model`` over
    every window of ``loader`` (the reference's ``evaluate_lm``). A ragged
    last batch is scored as it is: only its real rows enter the sum and
    the count. ``chunk`` takes the chunked tied head
    (:func:`tpudist_torch.models.lm_utils.chunked_ce_sum`), so the
    ``[B, S, V]`` logits never exist; ``input_transform`` applies to the
    model's input, never to the targets. Under a process group the sums
    and counts are added over the ranks. Returns ``{"loss": mean CE per
    predicted position, "perplexity": exp(loss)}`` (inf past exp's
    range, never clamped)."""
    import math

    from tpudist_torch.models.lm_utils import chunked_ce_sum, lm_head_weight

    model = state.model
    model.eval()
    device = next(model.parameters()).device
    layout = getattr(model, "layout", None)
    tensor = tp_lib.tensor_size(layout)
    sums = torch.zeros(2, dtype=torch.float64, device=device)
    for batch in prefetch_to_device(iter(loader), device):
        tokens = batch[input_key].long()
        inputs = _apply_input_transform(input_transform, tokens, batch)
        b, s = tokens.shape
        if chunk:
            hidden = model(inputs, return_hidden=True)
            ce = chunked_ce_sum(lm_head_weight(model), hidden[:, :-1],
                                tokens[:, 1:],
                                torch.ones((b, s - 1), device=device), chunk,
                                model=model)
        elif tensor > 1:
            # the tensor ranks score the same rows: every sum is counted
            # tensor times, the ratio not
            ce = tp_lm_loss(model(inputs, vocab_local=True), tokens, layout,
                            model.vocab_size) * (b * (s - 1))
        else:
            logits = model(inputs)[:, :-1]
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                                 tokens[:, 1:].reshape(-1), reduction="sum")
        sums[0] += ce
        sums[1] += b * (s - 1)
    if group_up():
        dist.all_reduce(sums)
    total, positions = sums.tolist()
    loss = total / max(positions, 1)
    ppl = math.exp(loss) if loss < 700.0 else float("inf")
    return {"loss": loss, "perplexity": ppl}
