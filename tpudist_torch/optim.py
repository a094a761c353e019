"""Optimizer construction: schedules, clipping, decay masks, optimizers.

Counterpart of :mod:`tpudist.optim` for what ``main.py`` uses:
:func:`make_optimizer` (``Adam(lr=1e-3)`` by default, AdamW with
``weight_decay``, global-norm clipping, the ``--amp`` guard) with its five
optimizers, ``adam`` unfused and fused (:func:`fused_adamw`), ``sgd``,
``lamb``, ``lion`` and ``muon``, and the warmup + cosine schedule.

Every optimizer follows optax's arithmetic, not ``torch.optim``'s (torch's
Adam folds the bias correction into the step size and divides by
``sqrt(v)/sqrt(bc2) + eps``, which rounds differently). The two Adams are
built on :func:`tpudist_torch.ops.fused_update.adamw_math`, the one
formula, so the unfused path (eager ops per leaf) and the fused path (one
multi-tensor kernel launch per step over every leaf) compute the same
bits. The others are eager ops per leaf, as the reference leaves them to
XLA: :class:`Muon`'s Newton-Schulz products are ``torch.matmul``.

An optimizer here updates in place under ``torch.no_grad``:
``tx.init(params)`` builds the state from a ``{name: tensor}`` dict (the
module's parameters), and ``tx.step(state, params, grads)`` applies one
update. The per-step scalars (the learning rate and the bias corrections
``1 - b**t``) come from the host step counter in float32, as the reference
computes them, so a step never reads a device value back. With
``guard=True`` (what :func:`tpudist_torch.amp.skip_nonfinite` asks for) a
step also computes a device flag from the gradients, writes every state
tensor and parameter through it (unchanged where a gradient holds an inf
or a NaN) and returns it.

Under FSDP (:mod:`tpudist_torch.parallel.fsdp`) the parameters and their
gradients are DTensors: every optimizer works on their local shards
(``to_local()``), and :meth:`Optimizer.shard_over` makes the global-norm
clip and the guard's flag span the fsdp group. :func:`shard_state` is
ZeRO-1: each state leaf is stored as this rank's slice over the data
replicas (:class:`ShardedStateOptimizer`), and
:meth:`Optimizer.slice_over` makes the guard's flag span them. Under a
tensor axis a rank slices its own tensor shards over its data replicas;
under FSDP with more than one data replica a leaf FSDP shards on a dim
``fsdp x data`` divides has its state sliced again over data (the
reference's ``(fsdp, data)`` overlay).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from tpudist_torch.amp import all_finite, skip_nonfinite
from tpudist_torch.ops import fused_update as FU
from tpudist_torch.ops.fused_update import adamw_math


def warmup_cosine(peak_lr: float, *, warmup_steps: int, total_steps: int,
                  end_lr_ratio: float = 0.0) -> Callable[[int], float]:
    """Linear warmup from 0 to ``peak_lr``, then cosine decay to
    ``peak_lr * end_lr_ratio`` at ``total_steps`` (optax's
    ``warmup_cosine_decay_schedule``)."""
    end_lr = peak_lr * end_lr_ratio
    alpha = 0.0 if peak_lr == 0.0 else end_lr / peak_lr
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"warmup_cosine needs total_steps > warmup_steps, got "
                         f"{total_steps} and {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return -peak_lr * frac + peak_lr
        t = min(count - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return peak_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def run_schedule(peak_lr: float, *, total_steps: int,
                 warmup_steps: int = 0) -> Callable[[int], float]:
    """:func:`warmup_cosine` sized to a run (one optimizer step per loader
    batch), warmup clamped to half the horizon so short runs still decay."""
    total = max(total_steps, 1)
    return warmup_cosine(peak_lr, warmup_steps=min(warmup_steps, total // 2),
                         total_steps=total)


def decay_mask(params: dict) -> dict[str, bool]:
    """True for leaves that SHOULD receive weight decay: everything except
    1-D params (biases, norm scales and offsets)."""
    return {k: p.ndim > 1 for k, p in params.items()}


def global_norm(tensors) -> torch.Tensor:
    """optax's ``global_norm``: sqrt of the sum of every tensor's sum of
    squares, each in the tensor's own dtype, on the device (no host
    read)."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """optax's ``clip_by_global_norm``: unchanged below ``max_norm``, else
    ``(g / norm) * max_norm``."""
    norm = global_norm(grads.values())
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for k, g in grads.items()}


def _f32(x: float) -> float:
    return float(np.float32(x))


def _bias_correction(b: float, t: int) -> float:
    """``1 - b**t`` in float32, as the reference computes it from its
    int32 step count."""
    return float(np.float32(1.0) - np.float32(b) ** np.float32(t))


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` rounded once, as the reference divides: PyTorch's CUDA
    kernels divide by a python scalar as a multiply by its reciprocal, so
    the divisor goes in as a 0-dim tensor."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def _writer(ok: torch.Tensor | None) -> Callable:
    """``put(dst, new)``: ``dst`` takes ``new``, or under the guard's
    ``ok`` flag keeps its value where ``ok`` is false (the reference's
    ``jnp.where(ok, new, old)``)."""
    if ok is None:
        return lambda dst, new: dst.copy_(new)
    return lambda dst, new: dst.copy_(torch.where(ok, new, dst))


def local(t):
    """The local shard of a DTensor (FSDP's parameters and gradients), or
    ``t`` itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def local_dict(tensors: dict) -> dict:
    return {k: local(t) for k, t in tensors.items()}


@torch.no_grad()
def load_tensors(dst: dict, src: dict, what: str) -> None:
    """Copy ``src``'s tensors into ``dst``'s by name, in place: the same
    names and shapes or a ``ValueError``, and a tensor that already is the
    destination, or a view of all of it (a checkpoint loaded into the
    live tensors), is left alone. Never rebinds an entry, so storage a kernel's table points at
    stays the storage it writes."""
    if set(dst) != set(src):
        raise ValueError(f"{what}: names differ ({sorted(set(dst) ^ set(src))})")
    for k, t in dst.items():
        s = src[k]
        if s is t or (s.data_ptr() == t.data_ptr() and s.device == t.device
                      and s.dtype == t.dtype and s.shape == t.shape):
            continue
        if tuple(s.shape) != tuple(t.shape):
            raise ValueError(f"{what}[{k!r}]: shape {tuple(s.shape)}, the "
                             f"state's is {tuple(t.shape)}")
        t.copy_(s)


@dataclasses.dataclass
class AdamState:
    """``count``: updates applied so far (a host integer); ``mu``/``nu``:
    the float32 moments by parameter name."""

    count: int
    mu: dict
    nu: dict

    def state_dict(self) -> dict:
        """The live tensors by name and the count (nothing copied)."""
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, sd: dict) -> None:
        """Take ``sd``'s count and copy its moments in place."""
        load_tensors(self.mu, sd["mu"], "mu")
        load_tensors(self.nu, sd["nu"], "nu")
        self.count = int(sd["count"])


@dataclasses.dataclass
class FusedAdamWState(AdamState):
    """Adds ``master``: the float32 master of each parameter. Without a
    compute copy it is the parameter itself; with one, it is a separate
    tensor and the parameter holds the copy. ``table``: the kernel's
    static table over every leaf (moments, master, copy, decay), built
    once at :meth:`FusedAdamW.init`; ``names`` orders its leaves;
    ``nonfinite``: the guard's int32 flag on the masters' device."""

    master: dict
    table: FU.AdamWTable
    names: list
    nonfinite: torch.Tensor | None = None

    def state_dict(self) -> dict:
        """:class:`AdamState`'s entries and ``master``, the float32
        masters; the compute copy is not kept (:meth:`load_state_dict`
        derives it)."""
        return {**super().state_dict(), "master": dict(self.master)}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy the moments and masters in place, then rewrite each compute
        copy as ``compute_dtype(master)``, which is what the kernel's last
        launch wrote. Every tensor keeps its storage, so the kernel's table
        (:class:`~tpudist_torch.ops.fused_update.AdamWTable`, built on
        their pointers) stays valid."""
        super().load_state_dict(sd)
        load_tensors(self.master, sd["master"], "master")
        for p, c in zip(self.table.p, self.table.copy):
            if c is not None:
                c.copy_(p.to(c.dtype))


class Optimizer:
    """What every optimizer here shares: the learning rate (a float or a
    schedule of the step count), the decoupled decay with its mask,
    global-norm clipping in front (``optax.clip_by_global_norm``), and
    :meth:`step`'s guard. A subclass gives :meth:`init` and
    ``_update(state, params, grads, put)``, which writes every state
    tensor and parameter through ``put``."""

    fused = False
    compute_dtype = None
    #: the update of one element reads no other element (ZeRO-1 may then
    #: update slices; Lamb's trust ratio and Muon's orthogonalization read
    #: the whole leaf)
    elementwise = True
    #: names whose (plain) parameters :meth:`init` takes as masters, as it
    #: takes FSDP's shards: no compute copy of them (ZeRO-1's slices of
    #: FSDP's shards)
    master_names = frozenset()

    def __init__(self, learning_rate: float | Callable[[int], float] = 1e-3,
                 *, weight_decay: float = 0.0,
                 mask: Callable[[dict], dict] | None = None,
                 clip_norm: float | None = None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.mask = mask
        self.clip_norm = clip_norm
        #: ``[(group, names)]``: the leaves each group holds in shards
        self.shards = []
        self.sliced = False
        self.slice_group = None

    def shard_over(self, group, sharded) -> None:
        """Gradients of the names in ``sharded`` are this rank's shards of
        leaves split over ``group`` (FSDP's, the tensor axis's or a pipe
        stage's); the others are replicated over it. The clip's global
        norm and the guard's flag then sum over the group, so every rank
        takes the same decision. Called once for
        each of two groups (fsdp x tensor, pipe x tensor), the norm divides
        each square by the size of every group that replicates its leaf
        and sums over both groups in turn; a second call for the same group
        replaces the first."""
        if not self.elementwise and sharded:
            raise NotImplementedError(
                f"{type(self).__name__} reads whole leaves (not an "
                "element-wise update), and FSDP or the tensor axis holds "
                "shards of them: run it without --fsdp / --tensor")
        self.shards = [(g, n) for g, n in self.shards if g is not group]
        self.shards.append((group, frozenset(sharded)))

    def slice_over(self, group) -> None:
        """:meth:`step` takes this rank's slices of gradients that are whole
        on every rank of ``group`` (ZeRO-1's data replicas; None: a
        one-process stand-in), clipped already: ZeRO-1 clips the whole
        gradients, as the replicated step does, before it slices them. The
        step then clips nothing, and the guard's flag spans ``group``."""
        self.sliced, self.slice_group = True, group

    def _flag_groups(self) -> list:
        return [g for g in (*(g for g, _ in self.shards), self.slice_group)
                if g is not None]

    def global_norm(self, grads: dict) -> torch.Tensor:
        """optax's ``global_norm`` of ``grads``; over the shard group the
        squares of sharded leaves are summed over the ranks, a replicated
        leaf's counted once."""
        if not self.shards:
            return global_norm(grads.values())
        import torch.distributed as dist

        # every rank's squares, a leaf's divided by the size of each group
        # that replicates it, summed over each group in turn
        sizes = [(n, dist.get_world_size(g)) for g, n in self.shards]
        total = torch.stack([
            torch.sum(torch.square(g.float()))
            / math.prod(w for n, w in sizes if k not in n)
            for k, g in grads.items()]).sum()
        for group, _ in self.shards:
            dist.all_reduce(total, group=group)
        return torch.sqrt(total)

    def all_finite(self, grads: dict) -> torch.Tensor:
        """The guard's flag: every gradient finite (on every rank of the
        shard and slice groups)."""
        ok = all_finite(grads)
        groups = self._flag_groups()
        if not groups:
            return ok
        import torch.distributed as dist

        bad = (~ok).to(torch.int32)
        for g in groups:
            dist.all_reduce(bad, group=g)
        return bad == 0

    def lr_at(self, count: int) -> float:
        """The learning rate of the update that follows ``count`` earlier
        ones, as a float32 value (the schedule reads the pre-increment
        count, as optax's does)."""
        lr = (self.learning_rate(count) if callable(self.learning_rate)
              else self.learning_rate)
        return _f32(lr)

    def leaf_decay(self, params: dict) -> dict[str, float]:
        """This step's decay coefficient per leaf (0 where masked off)."""
        if not self.weight_decay:
            return {k: 0.0 for k in params}
        mask = self.mask(params) if self.mask is not None else None
        return {k: self.weight_decay if mask is None or mask[k] else 0.0
                for k in params}

    def clip(self, grads: dict) -> dict:
        """``grads`` clipped to ``clip_norm`` by their global norm (over the
        shard group), or ``grads`` itself without a ``clip_norm``."""
        if self.clip_norm is None:
            return grads
        if not self.shards:
            return clip_by_global_norm(grads, self.clip_norm)
        norm = self.global_norm(grads)
        keep = norm < self.clip_norm
        return {k: torch.where(keep, g, (g / norm.to(g.dtype)) * self.clip_norm)
                for k, g in grads.items()}

    def _grads(self, grads: dict) -> dict:
        return grads if self.sliced else self.clip(grads)

    @torch.no_grad()
    def step(self, state, params: dict, grads: dict, *, guard: bool = False):
        """One update of every parameter in ``params``, in place. With
        ``guard`` the update is written only where every gradient is
        finite, and the step returns the device flag (true: skipped); it
        counts the step as taken either way."""
        params, grads = local_dict(params), local_dict(grads)
        ok = self.all_finite(grads) if guard else None
        self._update(state, params, self._grads(grads), _writer(ok))
        state.count += 1
        return None if ok is None else ~ok

    def _update(self, state, params, grads, put) -> None:
        raise NotImplementedError


class Adam(Optimizer):
    """``optax.adam`` / ``optax.adamw(mask=...)`` (optionally behind
    ``optax.clip_by_global_norm``), in optax's arithmetic, eager ops per
    leaf."""

    def __init__(self, learning_rate: float | Callable[[int], float] = 1e-3,
                 *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 mask: Callable[[dict], dict] | None = None,
                 clip_norm: float | None = None):
        super().__init__(learning_rate, weight_decay=weight_decay, mask=mask,
                         clip_norm=clip_norm)
        self.b1, self.b2, self.eps = b1, b2, eps

    def scalars(self, count: int) -> tuple[float, float, float]:
        """``(lr, b1c, b2c)`` of the update that follows ``count`` earlier
        ones, as float32 values: the schedule reads the pre-increment
        count, the bias corrections the post-increment one (optax)."""
        return (self.lr_at(count), _bias_correction(self.b1, count + 1),
                _bias_correction(self.b2, count + 1))

    def init(self, params: dict) -> AdamState:
        params = local_dict(params)
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return AdamState(0, zeros, {k: torch.zeros_like(z)
                                    for k, z in zeros.items()})

    def _update(self, state: AdamState, params, grads, put) -> None:
        lr, b1c, b2c = self.scalars(state.count)
        wds = self.leaf_decay(params)
        for k, p in params.items():
            m2, v2, u = adamw_math(
                grads[k], state.mu[k], state.nu[k], p, lr, b1c, b2c,
                b1=self.b1, b2=self.b2, eps=self.eps, wd=wds[k])
            put(state.mu[k], m2)
            put(state.nu[k], v2)
            put(p, p.float() + u)


class FusedAdamW(Adam):
    """:class:`Adam`'s update through the one-pass kernel, one launch per
    step over every leaf
    (:func:`tpudist_torch.ops.fused_update.fused_adamw_step`).

    ``compute_dtype`` (e.g. ``torch.bfloat16``) keeps a compute copy: at
    :meth:`init` the float32 masters move into the state and each float
    parameter becomes its copy in place (its ``.data`` cast), so the
    module's forward reads the copy and its gradients arrive in the
    compute dtype. Each step the kernel writes the new copy,
    ``compute_dtype(p + u)``, straight into the parameter's storage, and
    the new master ``p + u`` into the master's, in the same sweep as the
    moments. Without a copy the parameters are the masters. A parameter's
    storage must not be rebound (``p.data = ...``) after :meth:`init`: the
    table holds its pointer. Under the guard a check launch over the
    gradients sets the state's device flag first, and the update launch
    writes nothing when it is set."""

    fused = True

    def __init__(self, learning_rate=1e-3, *, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, mask=None, clip_norm=None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__(learning_rate, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay, mask=mask,
                         clip_norm=clip_norm)
        self.compute_dtype = compute_dtype

    @torch.no_grad()
    def init(self, params: dict) -> FusedAdamWState:
        base = super().init(params)
        # FSDP's sharded parameters: their local shards are the masters,
        # and FSDP's mixed-precision cast at the all-gather makes the copy
        sharded = {k for k, p in params.items() if hasattr(p, "to_local")}
        sharded |= self.master_names
        params = local_dict(params)
        if self.compute_dtype is None:
            master = dict(params)
        else:
            master = {k: p if k in sharded else p.detach().float().clone()
                      for k, p in params.items()}
            for k, p in params.items():
                if p.is_floating_point() and k not in sharded:
                    p.data = p.data.to(self.compute_dtype)
        names = list(params)
        wds = self.leaf_decay(master)
        table = FU.AdamWTable(
            [base.mu[k] for k in names], [base.nu[k] for k in names],
            [master[k] for k in names],
            [params[k] if master[k] is not params[k] else None
             for k in names], [wds[k] for k in names])
        flag = torch.zeros((), dtype=torch.int32, device=(
            master[names[0]].device if names else None))
        return FusedAdamWState(0, base.mu, base.nu, master, table, names,
                               flag)

    @torch.no_grad()
    def step(self, state: FusedAdamWState, params: dict, grads: dict, *,
             guard: bool = False):
        if list(params) != state.names:
            raise ValueError("fused_adamw: step's parameters differ from "
                             "those the state was built for")
        grads = local_dict(grads)
        flag = None
        if guard:
            # the check launch over this rank's leaves (shards, slices),
            # then the flag summed over the ranks holding the others
            flag = state.nonfinite
            FU.nonfinite_check(state.table, [grads[k] for k in state.names],
                               flag)
            for g in self._flag_groups():
                import torch.distributed as dist

                dist.all_reduce(flag, group=g)
        grads = self._grads(grads)
        lr, b1c, b2c = self.scalars(state.count)
        FU.fused_adamw_step(state.table, [grads[k] for k in state.names], lr,
                            b1c, b2c, b1=self.b1, b2=self.b2, eps=self.eps,
                            nonfinite=flag)
        state.count += 1
        return flag


def fused_adamw(learning_rate=1e-3, *, b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=0.0, mask=None, clip_norm=None,
                compute_dtype=None) -> FusedAdamW:
    """The fused optimizer (:class:`FusedAdamW`); matches ``optax.adamw``
    with ``mask`` (plain ``optax.adam`` at ``weight_decay=0``), with
    ``clip_norm`` as ``optax.clip_by_global_norm`` in front."""
    return FusedAdamW(learning_rate, b1=b1, b2=b2, eps=eps,
                      weight_decay=weight_decay, mask=mask,
                      clip_norm=clip_norm, compute_dtype=compute_dtype)


@dataclasses.dataclass
class MomentState:
    """``count`` and one moment by parameter name (sgd's trace, lion's
    mu), each in its parameter's dtype as optax keeps them."""

    count: int
    mu: dict

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu)}

    def load_state_dict(self, sd: dict) -> None:
        load_tensors(self.mu, sd["mu"], "mu")
        self.count = int(sd["count"])


def _zeros(params: dict) -> dict:
    return {k: torch.zeros_like(p) for k, p in params.items()}


class SGD(Optimizer):
    """``optax.sgd(lr, momentum)``, with ``optax.add_decayed_weights`` in
    front of it when ``weight_decay > 0``: ``t' = (g + wd*p) + momentum*t``,
    ``p' = p + t' * -lr``."""

    def __init__(self, learning_rate=1e-3, *, momentum: float = 0.9,
                 weight_decay=0.0, mask=None, clip_norm=None):
        super().__init__(learning_rate, weight_decay=weight_decay, mask=mask,
                         clip_norm=clip_norm)
        self.momentum = momentum

    def init(self, params: dict) -> MomentState:
        return MomentState(0, _zeros(local_dict(params)))

    def _update(self, state: MomentState, params, grads, put) -> None:
        neg_lr = -self.lr_at(state.count)
        wds = self.leaf_decay(params)
        for k, p in params.items():
            g = grads[k] + wds[k] * p if wds[k] else grads[k]
            t = g + self.momentum * state.mu[k]
            put(state.mu[k], t)
            put(p, p + neg_lr * t)


class Lion(Optimizer):
    """``optax.lion``: ``u = sign((1-b1)*g + b1*m)``, ``m' = (1-b2)*g +
    b2*m``, then the masked decay ``u + wd*p`` and ``p' = p + u * -lr``."""

    def __init__(self, learning_rate=1e-4, *, b1: float = 0.9,
                 b2: float = 0.99, weight_decay=1e-3, mask=None,
                 clip_norm=None):
        super().__init__(learning_rate, weight_decay=weight_decay, mask=mask,
                         clip_norm=clip_norm)
        self.b1, self.b2 = b1, b2

    def init(self, params: dict) -> MomentState:
        return MomentState(0, _zeros(local_dict(params)))

    def _update(self, state: MomentState, params, grads, put) -> None:
        neg_lr = -self.lr_at(state.count)
        wds = self.leaf_decay(params)
        for k, p in params.items():
            g, m = grads[k], state.mu[k]
            u = torch.sign((1.0 - self.b1) * g + self.b1 * m)
            put(m, (1.0 - self.b2) * g + self.b2 * m)
            if wds[k]:
                u = u + wds[k] * p
            put(p, p + neg_lr * u)


def _norm(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(t * t))


class Lamb(Adam):
    """``optax.lamb``: Adam's direction ``m_hat / (sqrt(v_hat) + eps)``,
    the masked decay ``+ wd*p``, then each leaf scaled by its trust ratio
    ``||p|| / ||u||`` (1 where either norm is 0) and by ``-lr``."""

    elementwise = False

    def __init__(self, learning_rate=1e-3, *, b1=0.9, b2=0.999, eps=1e-6,
                 weight_decay=0.0, mask=None, clip_norm=None):
        super().__init__(learning_rate, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay, mask=mask,
                         clip_norm=clip_norm)

    def _update(self, state: AdamState, params, grads, put) -> None:
        lr, b1c, b2c = self.scalars(state.count)
        wds = self.leaf_decay(params)
        for k, p in params.items():
            m2, v2, d = adamw_math(
                grads[k], state.mu[k], state.nu[k], p, -1.0, b1c, b2c,
                b1=self.b1, b2=self.b2, eps=self.eps, wd=wds[k])
            pn, un = _norm(p), _norm(d)
            ratio = torch.where((pn == 0.0) | (un == 0.0),
                                torch.ones_like(pn), pn / un)
            put(state.mu[k], m2)
            put(state.nu[k], v2)
            put(p, p + (d * ratio) * -lr)


#: top-level names whose leaves stay on Adam under Muon: embeddings and
#: classifier / LM heads (the reference's list, ``tpudist/optim.py``;
#: ``Dense_0`` is its ResNet's head, ``head`` here)
_ADAM_TOP = ("wte", "wpe", "embed", "lm_head", "embedding", "head", "Dense_0")


def muon_view(name: str, p: torch.Tensor):
    """How :class:`Muon` routes the port's leaf ``name``: ``None`` for
    Adam, else ``(to_matrix, from_matrix)``, the functions between the
    leaf and the matrix ``[reduction, output]`` the reference
    orthogonalizes for the same leaf of the flax model
    (``MuonDimensionNumbers`` of ``tpudist/optim.py``'s ``muon_dims``).

    The reference routes by flax names: only ``kernel`` leaves of two or
    more dims outside the embeddings and heads take Muon, a conv kernel
    (``[kh, kw, in, out]``) reduces over its first three axes, ``out``
    over its leading two, every other kernel over its first. Here a
    kernel is a ``weight``: a ``Dense`` weight ``[out, in]`` (``qkv``'s
    and ``out``'s grouped axes flattened) is that matrix transposed, and a
    conv weight ``[out, in, kh, kw]`` is permuted to ``[kh, kw, in, out]``
    and flattened."""
    parts = name.split(".")
    if p.ndim < 2 or parts[0] in _ADAM_TOP or parts[-1] != "weight":
        return None
    if p.ndim == 4 and any("conv" in s.lower() for s in parts[:-1]):
        o, i, kh, kw = p.shape
        return (lambda t: t.permute(2, 3, 1, 0).reshape(kh * kw * i, o),
                lambda m: m.reshape(kh, kw, i, o).permute(3, 2, 0, 1))
    if p.ndim == 2:
        return (lambda t: t.t(), lambda m: m.t())
    raise ValueError(f"muon: no matrix view of {name!r} {tuple(p.shape)}")


#: optax.contrib.muon's Newton-Schulz coefficients, 5 steps
NS_COEFFS, NS_STEPS = (3.4445, -4.7750, 2.0315), 5


def orthogonalize(x: torch.Tensor, *, eps: float = 1e-8,
                  coeffs=NS_COEFFS, steps: int = NS_STEPS) -> torch.Tensor:
    """optax's ``orthogonalize_via_newton_schulz`` on one matrix
    ``[reduction, output]``: transposed when it has more rows than
    columns, divided by its Frobenius norm plus ``eps``, then ``steps``
    quintic iterations ``c0*X + (c1*A + (c2*A) @ A) @ X``, ``A = X X^T``
    (the reference's order of operations)."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.t()
    x = x / (_norm(x) + eps)
    c0, c1, c2 = coeffs
    for _ in range(steps):
        a = x @ x.t()
        b = c1 * a + (c2 * a) @ a
        x = c0 * x + b @ x
    return x.t() if transposed else x


@dataclasses.dataclass
class MuonState:
    """``count``; ``mu`` the momentum of the Muon-routed leaves; ``adam_mu``
    and ``adam_nu`` the moments of the rest."""

    count: int
    mu: dict
    adam_mu: dict
    adam_nu: dict

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu),
                "adam_mu": dict(self.adam_mu), "adam_nu": dict(self.adam_nu)}

    def load_state_dict(self, sd: dict) -> None:
        for name in ("mu", "adam_mu", "adam_nu"):
            load_tensors(getattr(self, name), sd[name], name)
        self.count = int(sd["count"])


class Muon(Optimizer):
    """``optax.contrib.muon`` as the reference builds it: the leaves
    :func:`muon_view` routes take Nesterov momentum (``beta``) bias-
    corrected, orthogonalized (:func:`orthogonalize`) on the reference's
    matrix view, scaled by ``sqrt(max(1, out / in))``, the masked decay
    added, times ``-lr``; the rest take Nesterov Adam (``adam_b1``,
    ``adam_b2``, ``eps``, no decay)."""

    elementwise = False

    def __init__(self, learning_rate=1e-3, *, beta: float = 0.95,
                 eps: float = 1e-8, weight_decay=0.0, mask=None,
                 adam_b1: float = 0.9, adam_b2: float = 0.999,
                 clip_norm=None):
        super().__init__(learning_rate, weight_decay=weight_decay, mask=mask,
                         clip_norm=clip_norm)
        self.beta, self.eps = beta, eps
        self.adam_b1, self.adam_b2 = adam_b1, adam_b2

    def init(self, params: dict) -> MuonState:
        params = local_dict(params)
        routed = {k for k, p in params.items() if muon_view(k, p)}
        mu = _zeros({k: params[k] for k in routed})
        rest = {k: p for k, p in params.items() if k not in routed}
        return MuonState(0, mu, _zeros(rest), _zeros(rest))

    def _update(self, state: MuonState, params, grads, put) -> None:
        c = state.count
        neg_lr = -self.lr_at(c)
        wds = self.leaf_decay(params)
        beta, b1, b2 = self.beta, self.adam_b1, self.adam_b2
        for k, p in params.items():
            g = grads[k]
            if k in state.mu:
                m = (1.0 - beta) * g + beta * state.mu[k]
                # Nesterov: the moment corrected a step ahead, the gradient
                # at this step's count
                mhat = (beta * _div(m, _bias_correction(beta, c + 2))
                        + (1.0 - beta) * _div(g, _bias_correction(beta, c + 1)))
                to_m, from_m = muon_view(k, p)
                mat = to_m(mhat)
                red, out = mat.shape
                scale = float(np.sqrt(np.float32(max(1.0, out / red))))
                u = scale * from_m(orthogonalize(mat, eps=self.eps))
                if wds[k]:
                    u = u + wds[k] * p
                put(state.mu[k], m)
            else:
                m = (1.0 - b1) * g + b1 * state.adam_mu[k]
                v = (1.0 - b2) * torch.square(g) + b2 * state.adam_nu[k]
                mhat = (b1 * _div(m, _bias_correction(b1, c + 2))
                        + (1.0 - b1) * _div(g, _bias_correction(b1, c + 1)))
                vhat = _div(v, _bias_correction(b2, c + 1))
                u = mhat / (torch.sqrt(vhat) + self.eps)
                put(state.adam_mu[k], m)
                put(state.adam_nu[k], v)
            put(p, p + u * neg_lr)


def make_optimizer(lr: float | Callable[[int], float] = 1e-3, *,
                   optimizer: str = "adam", b1: float = 0.9,
                   b2: float | None = None, eps: float = 1e-8,
                   weight_decay: float = 0.0, clip_norm: float | None = None,
                   skip_nonfinite_updates: bool = False, fused: bool = False,
                   compute_dtype: torch.dtype | None = None):
    """The reference's factory. Defaults reproduce ``Adam(lr=1e-3)``.
    ``weight_decay > 0`` is decoupled decay masked off 1-D params (AdamW
    for adam; sgd adds it before the momentum); ``clip_norm`` clips by the
    global norm first; ``skip_nonfinite_updates`` wraps the optimizer in
    :func:`tpudist_torch.amp.skip_nonfinite`; ``fused=True`` builds
    :func:`fused_adamw` (adam only, as the reference's; ``compute_dtype``
    keeps its compute copy). ``b2`` defaults to 0.99 for lion, else
    0.999."""
    if b2 is None:
        b2 = 0.99 if optimizer == "lion" else 0.999
    if fused and optimizer != "adam":
        raise ValueError(f"fused=True implements the adam/adamw update only, "
                         f"got optimizer={optimizer!r}")
    mask = decay_mask if weight_decay > 0.0 else None
    common = dict(weight_decay=weight_decay, clip_norm=clip_norm)
    if fused:
        tx = fused_adamw(lr, b1=b1, b2=b2, eps=eps, mask=mask,
                         compute_dtype=compute_dtype, **common)
    elif optimizer == "adam":
        tx = Adam(lr, b1=b1, b2=b2, eps=eps, mask=mask, **common)
    elif optimizer == "sgd":
        tx = SGD(lr, momentum=b1, mask=mask, **common)
    elif optimizer == "lamb":
        tx = Lamb(lr, b1=b1, b2=b2, eps=eps, mask=decay_mask, **common)
    elif optimizer == "lion":
        tx = Lion(lr, b1=b1, b2=b2, mask=decay_mask, **common)
    elif optimizer == "muon":
        tx = Muon(lr, eps=eps, mask=decay_mask, adam_b1=b1, adam_b2=b2,
                  **common)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return skip_nonfinite(tx) if skip_nonfinite_updates else tx


# --------------------------------------------------------------------------
# ZeRO-1: the optimizer state stored as this rank's slice over the data
# replicas (the reference's shard_state, arXiv:2004.13336)
# --------------------------------------------------------------------------


def _zero1_layout(shape, world: int, min_size: int):
    """How one leaf is stored under ZeRO-1 (the reference's rule):
    ``("replicate", None)`` for scalars and leaves under ``min_size``;
    ``("shard", dim)`` on the largest ``world``-divisible dim (the natural
    shape, split); ``("pad", cols)`` when no dim divides (flattened,
    zero-padded to ``world * cols`` and viewed ``[world, cols]``)."""
    from tpudist_torch.mesh import largest_divisible_dim

    if world <= 1 or len(shape) == 0 or math.prod(shape) < min_size:
        return ("replicate", None)
    dim = largest_divisible_dim(tuple(shape), world, min_size=min_size)
    if dim is not None:
        return ("shard", dim)
    return ("pad", -(-math.prod(shape) // world))


def _named_leaves(state, name: str):
    """Every tensor of an optimizer state (its dataclass fields, nested
    states and dicts) stored under parameter ``name``."""
    out = []

    def walk(x):
        if dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            t = x.get(name)
            if isinstance(t, torch.Tensor):
                out.append(t)

    walk(state)
    return out


@dataclasses.dataclass
class ZeroState:
    """:class:`ShardedStateOptimizer`'s state: ``inner`` the wrapped
    optimizer's state over ``slices`` (this rank's slice of each leaf, the
    leaf itself where it is replicated), ``modes`` each leaf's
    classification, ``params`` the module's parameters (the gather's
    destination)."""

    inner: object
    slices: dict
    modes: dict
    params: dict
    world: int
    rank: int
    mesh: object = None
    #: the sliced leaves that are themselves a rank's shard (a tensor
    #: shard, an FSDP shard): a checkpoint holds them gathered over the
    #: data replicas, at the shard's shape, which the train state places
    #: as the parameter is placed
    nested: frozenset = frozenset()

    def _dtensor(self, name: str, t: torch.Tensor):
        mode, info = self.modes[name]
        if mode == "replicate" or self.mesh is None:
            return t
        if name in self.nested:
            return _assemble(_all_gather(self, t), mode, info,
                             local(self.params[name]).shape)
        from torch.distributed.tensor import DTensor, Shard

        shape = self.params[name].shape
        if mode == "pad":
            return DTensor.from_local(t, self.mesh, [Shard(0)],
                                      run_check=False,
                                      shape=(self.world, info),
                                      stride=(info, 1))
        return DTensor.from_local(t, self.mesh, [Shard(info)],
                                  run_check=False, shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    def state_dict(self) -> dict:
        """The inner state's entries, each sliced leaf a DTensor over the
        data replicas (``Shard(dim)`` of its natural shape, ``Shard(0)``
        of ``[world, cols]``), so a DCP checkpoint holds one global array
        per leaf."""
        def wrap(x):
            if isinstance(x, dict):
                return {k: (self._dtensor(k, v) if k in self.modes and
                            isinstance(v, torch.Tensor) else wrap(v))
                        for k, v in x.items()}
            return x

        return wrap(self.inner.state_dict())

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Load the inner state (its DTensors' local slices), then make the
        slices and the module's parameters agree: a parameter loaded in
        full refreshes its slice; a master held in slices is gathered into
        the parameter."""
        def unwrap(x, name=None):
            if isinstance(x, dict):
                return {k: unwrap(v, k) for k, v in x.items()}
            x = local(x)
            if name in self.nested and isinstance(x, torch.Tensor) and (
                    x.shape == local(self.params[name]).shape):
                # held gathered over the data replicas: this rank's slice
                x = _slice_of(x, *self.modes[name], self.world, self.rank)
            return x

        self.inner.load_state_dict(unwrap(sd))
        held = getattr(_base_state(self.inner), "master", {})
        for name, (mode, _) in self.modes.items():
            if (mode == "replicate" or name in held
                    or self.slices[name] is self.params[name]):
                continue
            self.slices[name].copy_(_slice_of(local(self.params[name]), mode,
                                              self.modes[name][1],
                                              self.world, self.rank))
        if held:
            gather_slices(self)

    def full_masters(self) -> dict:
        """Every parameter's float32 master in full (a gather of the
        sliced ones over the data replicas: every rank must call it)."""
        held = getattr(_base_state(self.inner), "master", {})
        out = {}
        for name, p in self.params.items():
            mode, info = self.modes[name]
            src = held.get(name, self.slices[name])
            # a whole-leaf optimizer keeps the parameters whole
            out[name] = (src if mode == "replicate" or src is p else
                         _assemble(_all_gather(self, src), mode, info,
                                   local(p).shape))
        return out


def _reslice(state, name: str, mode: str, info, world: int,
             rank: int) -> None:
    """Replace each tensor of ``state`` stored under ``name`` by this
    rank's slice of it."""
    def walk(x):
        if dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict) and isinstance(x.get(name), torch.Tensor):
            x[name] = _slice_of(x[name], mode, info, world, rank)

    walk(state)


def _move_scalars(src, dst) -> None:
    """Copy the host scalars (counts, the guard's pending flag) of one
    optimizer state onto another of the same structure."""
    for f in dataclasses.fields(src):
        v = getattr(src, f.name)
        if dataclasses.is_dataclass(v):
            _move_scalars(v, getattr(dst, f.name))
        elif not isinstance(v, (dict, torch.Tensor)):
            setattr(dst, f.name, v)


def _base_state(state):
    from tpudist_torch.amp import inner_state

    return inner_state(state)


def _slice_of(p: torch.Tensor, mode: str, info, world: int, rank: int):
    """This rank's slice of leaf ``p`` as a new contiguous tensor."""
    if mode == "shard":
        return p.detach().chunk(world, info)[rank].contiguous()
    flat = p.detach().reshape(-1)
    row = torch.zeros((1, info), dtype=p.dtype, device=p.device)
    lo = rank * info
    hi = min(lo + info, flat.numel())
    if hi > lo:
        row[0, :hi - lo] = flat[lo:hi]
    return row


def _assemble(parts: list, mode: str, info, shape) -> torch.Tensor:
    if mode == "shard":
        return torch.cat(parts, info)
    return torch.cat([t.reshape(-1) for t in parts])[:math.prod(shape)].view(
        shape)


def _all_gather(state: ZeroState, t: torch.Tensor) -> list:
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(state.world)]
    dist.all_gather(parts, t.contiguous(), group=state.mesh.get_group())
    return parts


@torch.no_grad()
def gather_slices(state: ZeroState) -> None:
    """All-gather every sliced leaf's updated slice into the module's
    parameter (the params all-gather ZeRO-1 pays every step)."""
    for name, (mode, info) in state.modes.items():
        if mode == "replicate":
            continue
        p = local(state.params[name])
        p.copy_(_assemble(_all_gather(state, state.slices[name]), mode,
                          info, p.shape))


class ShardedStateOptimizer:
    """ZeRO-1 around a port optimizer (:func:`shard_state`). ``world`` /
    ``rank``: this rank's place among the data replicas; ``mesh``: their
    DeviceMesh (None: a one-process stand-in that only updates slices,
    as chip_smoke.py's phase 56 drives it)."""

    def __init__(self, inner, *, world: int, rank: int, mesh=None,
                 min_size: int = 1024, skip_spec=None, skip_name=None):
        self.inner = inner
        self.world, self.rank, self.mesh = int(world), int(rank), mesh
        self.min_size = int(min_size)
        self.skip_spec = skip_spec
        self.skip_name = skip_name
        # whether FSDP shards the model (set by init from its parameters)
        self.fsdp = False
        base = self._base()
        if base.elementwise:
            # the inner step takes slices: its guard (the check kernel
            # under the fused AdamW) spans the data replicas, and the clip
            # runs here, on the whole gradients (:meth:`update`)
            base.slice_over(mesh.get_group() if mesh is not None else None)

    @property
    def fused(self) -> bool:
        return getattr(self.inner, "fused", False)

    @property
    def compute_dtype(self):
        return getattr(self.inner, "compute_dtype", None)

    def _base(self):
        return getattr(self.inner, "inner", self.inner)

    def _held(self) -> frozenset:
        """The names the inner optimizer was told are shards of a group
        (:meth:`Optimizer.shard_over`: the tensor axis's, FSDP's)."""
        return frozenset().union(*(n for _, n in self._base().shards))

    def layout(self, p, name: str | None = None) -> tuple:
        """The leaf's classification: a DTensor (FSDP's shard) is sliced
        again over data on FSDP's dim where that dim divides (the
        reference's ``(fsdp, data)`` overlay), else stays natural
        (``replicate``); beside FSDP a leaf a group holds in shards (the
        tensor axis's) stays natural, as does one ``skip_spec`` (by its
        shape) or ``skip_name`` (by its name) exempts."""
        if hasattr(p, "to_local"):
            dim = getattr(p.placements[-1], "dim", None)
            if (self.world > 1 and dim is not None
                    and p.to_local().shape[dim] % self.world == 0):
                return ("shard", dim)
            return ("replicate", None)
        if (self.fsdp and name in self._held()) or (
                self.skip_spec is not None and self.skip_spec(tuple(p.shape))
        ) or (self.skip_name is not None and name is not None
              and self.skip_name(name)):
            return ("replicate", None)
        return _zero1_layout(tuple(p.shape), self.world, self.min_size)

    @torch.no_grad()
    def init(self, params: dict) -> ZeroState:
        base = self._base()
        self.fsdp = any(hasattr(p, "to_local") for p in params.values())
        modes = {k: self.layout(p, k) for k, p in params.items()}
        held = self._held()
        nested = frozenset(
            k for k, p in params.items() if modes[k][0] != "replicate"
            and (k in held or hasattr(p, "to_local")))
        if not base.elementwise:
            # Lamb's trust ratio and Muon's orthogonalization read whole
            # leaves: the state is built whole and stored as slices
            state = ZeroState(self.inner.init(dict(params)), dict(params),
                              modes, dict(params), self.world, self.rank,
                              self.mesh, nested)
            for name, (mode, info) in modes.items():
                if mode != "replicate":
                    _reslice(state.inner, name, mode, info, self.world,
                             self.rank)
            return state
        slices = {k: (p if modes[k][0] == "replicate" else
                      _slice_of(local(p), *modes[k], self.world, self.rank))
                  for k, p in params.items()}
        if base.mask is not None:
            # the decay mask reads the leaves' natural shapes (a pad slice
            # of a 1-D leaf is 2-D)
            natural = base.mask(params)
            base.mask = lambda _slices: natural
        # an FSDP shard's slices are masters: FSDP casts the gathered
        # parameter to the compute dtype itself
        fsdp = {k for k, p in params.items()
                if hasattr(p, "to_local") and modes[k][0] != "replicate"}
        base.master_names = frozenset(fsdp)
        inner = self.inner.init(slices)
        if self.compute_dtype is not None:
            # the module holds the whole compute copy, gathered each step
            # from the slices the kernel writes
            for k, p in params.items():
                if (modes[k][0] != "replicate" and p.is_floating_point()
                        and k not in fsdp):
                    p.data = p.data.to(self.compute_dtype)
        return ZeroState(inner, slices, modes, dict(params), self.world,
                         self.rank, self.mesh, nested)

    @torch.no_grad()
    def update(self, state: ZeroState, grads: dict):
        """Clip the whole (replicated, already reduced) gradients, then
        update this rank's slices through the inner optimizer with their
        slices: under the fused AdamW one kernel launch over the slices
        (and, under the ``--amp`` guard, one check launch, its flag summed
        over the data replicas). The pad region is re-zeroed. The guard
        reads clipped gradients: the clip keeps a finite gradient finite
        and turns a non-finite one's whole tree into NaN or zeros around
        it, so the decision is the unclipped gradients'."""
        base = self._base()
        grads = local_dict(grads)
        if not base.elementwise:
            return self._update_whole(state, grads)
        grads = base.clip(grads)
        gslices = {k: (g if state.modes[k][0] == "replicate" else
                       _slice_of(g, *state.modes[k], self.world, self.rank))
                   for k, g in grads.items()}
        self.inner.step(state.inner, state.slices, gslices)
        for name, (mode, cols) in state.modes.items():
            if mode != "pad":
                continue
            valid = max(0, min(cols, state.params[name].numel()
                               - self.rank * cols))
            for t in (state.slices[name], *_named_leaves(state.inner, name)):
                t.view(-1)[valid:].zero_()

    def _update_whole(self, state: ZeroState, grads: dict) -> None:
        """An update that reads whole leaves: the state's slices are
        gathered into a whole state, the inner step runs on it and on the
        whole (replicated) parameters as on every replica, and this
        rank's slices are kept. The update is the replicated one bit for
        bit; the state rests sliced."""
        params = local_dict(state.params)
        whole = self.inner.init(dict(params))
        for name, (mode, info) in state.modes.items():
            for src, dst in zip(_named_leaves(state.inner, name),
                                _named_leaves(whole, name)):
                dst.copy_(src if mode == "replicate" else
                          _assemble(_all_gather(state, src), mode, info,
                                    dst.shape))
        _move_scalars(state.inner, whole)
        self.inner.step(whole, params, grads)
        _move_scalars(whole, state.inner)
        for name, (mode, info) in state.modes.items():
            for src, dst in zip(_named_leaves(whole, name),
                                _named_leaves(state.inner, name)):
                dst.copy_(src if mode == "replicate" else
                          _slice_of(src, mode, info, self.world, self.rank))

    @torch.no_grad()
    def step(self, state: ZeroState, params: dict, grads: dict) -> None:
        """:meth:`update`, then the params all-gather (a whole-leaf
        update wrote the parameters whole)."""
        self.update(state, grads)
        if self._base().elementwise:
            gather_slices(state)


def shard_state(tx, layout=None, *, world: int | None = None,
                rank: int | None = None, mesh=None, min_size: int = 1024,
                skip_spec=None) -> ShardedStateOptimizer:
    """ZeRO-1 over ``layout``'s data replicas (its data DeviceMesh), or
    over an explicit ``world`` / ``rank`` / ``mesh``: each state leaf
    stored per :func:`_zero1_layout`, the update run on this rank's slices
    with the replicated gradient's slices, then the parameters all-
    gathered. Apply it outermost (around the ``--amp`` guard). The fused
    AdamW then runs its kernel once a step over the table of this rank's
    slices, bit-equal on those elements to the replicated launch (AdamW is
    element-wise). ``skip_spec(shape) -> bool`` exempts leaves (the plan's
    fsdp-sharded ones); FSDP's shards and, beside them, the tensor axis's
    are classified by :meth:`ShardedStateOptimizer.layout`. On a layout
    with an expert axis the stacked expert leaves keep their state whole
    (the reference's ``wrap_zero1`` exempts them)."""
    skip_name = None
    if layout is not None:
        world = layout.data
        rank = layout.data_idx
        mesh = layout.data_mesh()
        if getattr(layout, "expert", 1) > 1:
            from tpudist_torch.parallel.ep import is_expert_leaf

            skip_name = is_expert_leaf
    return ShardedStateOptimizer(tx, world=world or 1, rank=rank or 0,
                                 mesh=mesh, min_size=min_size,
                                 skip_spec=skip_spec, skip_name=skip_name)
