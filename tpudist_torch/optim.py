"""Optimizer construction: schedules, clipping, decay masks, Adam.

Counterpart of :mod:`tpudist.optim` for what the training main path uses:
:func:`make_optimizer`'s ``adam`` branch (``Adam(lr=1e-3)`` by default,
AdamW with ``weight_decay``, global-norm clipping) unfused and fused
(:func:`fused_adamw`), and the warmup + cosine schedule.

Both optimizers follow optax's arithmetic, not ``torch.optim.Adam``'s:
torch folds the bias correction into the step size and divides by
``sqrt(v)/sqrt(bc2) + eps``, which rounds differently. Both are built on
:func:`tpudist_torch.ops.fused_update.adamw_math`, the one formula, so the
unfused path (eager ops per leaf) and the fused path (one kernel launch
per leaf of at least 1024 elements) compute the same bits.

An optimizer here updates in place under ``torch.no_grad``:
``tx.init(params)`` builds the state from a ``{name: tensor}`` dict (the
module's parameters), and ``tx.step(state, params, grads)`` applies one
update. The per-step scalars ``lr``, ``b1c = 1 - b1**t`` and
``b2c = 1 - b2**t`` come from the host step counter in float32, as the
reference computes them, so a step never reads a device value back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from tpudist_torch.ops.fused_update import adamw_math, fused_leaf_update


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


@dataclasses.dataclass
class AdamState:
    """``count``: updates applied so far (a host integer); ``mu``/``nu``:
    the float32 moments by parameter name."""

    count: int
    mu: dict
    nu: dict


@dataclasses.dataclass
class FusedAdamWState(AdamState):
    """Adds ``master``: the float32 master of each parameter. Without a
    compute copy it is the parameter itself; with one, it is a separate
    tensor and the parameter holds the copy."""

    master: dict


class Adam:
    """``optax.adam`` / ``optax.adamw(mask=...)`` (optionally behind
    ``optax.clip_by_global_norm``), in optax's arithmetic, eager ops per
    leaf."""

    fused = False
    compute_dtype = None

    def __init__(self, learning_rate: float | Callable[[int], float] = 1e-3,
                 *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 mask: Callable[[dict], dict] | None = None,
                 clip_norm: float | None = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mask = mask
        self.clip_norm = clip_norm

    def scalars(self, count: int) -> tuple[float, float, float]:
        """``(lr, b1c, b2c)`` of the update that follows ``count`` earlier
        ones, as float32 values: the schedule reads the pre-increment
        count, the bias corrections the post-increment one (optax)."""
        t = np.float32(count + 1)
        b1c = np.float32(1.0) - np.float32(self.b1) ** t
        b2c = np.float32(1.0) - np.float32(self.b2) ** t
        lr = (self.learning_rate(count) if callable(self.learning_rate)
              else self.learning_rate)
        return _f32(lr), float(b1c), float(b2c)

    def leaf_decay(self, params: dict) -> dict[str, float]:
        """This step's decay coefficient per leaf (0 where masked off)."""
        if not self.weight_decay:
            return {k: 0.0 for k in params}
        mask = self.mask(params) if self.mask is not None else None
        return {k: self.weight_decay if mask is None or mask[k] else 0.0
                for k in params}

    def init(self, params: dict) -> AdamState:
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return AdamState(0, zeros, {k: torch.zeros_like(z)
                                    for k, z in zeros.items()})

    def _grads(self, grads: dict) -> dict:
        if self.clip_norm is not None:
            return clip_by_global_norm(grads, self.clip_norm)
        return grads

    @torch.no_grad()
    def step(self, state: AdamState, params: dict, grads: dict) -> None:
        """One update of every parameter in ``params``, in place."""
        grads = self._grads(grads)
        lr, b1c, b2c = self.scalars(state.count)
        wds = self.leaf_decay(params)
        for k, p in params.items():
            m2, v2, u = adamw_math(
                grads[k], state.mu[k], state.nu[k], p, lr, b1c, b2c,
                b1=self.b1, b2=self.b2, eps=self.eps, wd=wds[k])
            state.mu[k].copy_(m2)
            state.nu[k].copy_(v2)
            p.copy_(p.float() + u)
        state.count += 1


class FusedAdamW(Adam):
    """:class:`Adam`'s update through the one-pass kernel
    (:func:`tpudist_torch.ops.fused_update.fused_leaf_update`).

    ``compute_dtype`` (e.g. ``torch.bfloat16``) keeps a compute copy: at
    :meth:`init` the float32 masters move into the state and each float
    parameter becomes its copy in place (its ``.data`` cast), so the
    module's forward reads the copy and its gradients arrive in the
    compute dtype. Each step the kernel writes the new copy,
    ``compute_dtype(p + u)``, straight into the parameter's storage, in the
    same sweep as the moments. Without a copy the parameters are the
    masters and ``p += u``."""

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
        if self.compute_dtype is None:
            master = dict(params)
        else:
            master = {k: p.detach().float().clone() for k, p in params.items()}
            for p in params.values():
                if p.is_floating_point():
                    p.data = p.data.to(self.compute_dtype)
        return FusedAdamWState(0, base.mu, base.nu, master)

    @torch.no_grad()
    def step(self, state: FusedAdamWState, params: dict, grads: dict) -> None:
        grads = self._grads(grads)
        lr, b1c, b2c = self.scalars(state.count)
        wds = self.leaf_decay(state.master)
        for k, p in params.items():
            master = state.master[k]
            copy = p if master is not p else None
            u, _, _, _ = fused_leaf_update(
                grads[k], state.mu[k], state.nu[k], master, lr, b1c, b2c,
                b1=self.b1, b2=self.b2, eps=self.eps, wd=wds[k],
                m_out=state.mu[k], v_out=state.nu[k], copy_out=copy)
            master.add_(u)
        state.count += 1


def fused_adamw(learning_rate=1e-3, *, b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=0.0, mask=None, clip_norm=None,
                compute_dtype=None) -> FusedAdamW:
    """The fused optimizer (:class:`FusedAdamW`); matches ``optax.adamw``
    with ``mask`` (plain ``optax.adam`` at ``weight_decay=0``), with
    ``clip_norm`` as ``optax.clip_by_global_norm`` in front."""
    return FusedAdamW(learning_rate, b1=b1, b2=b2, eps=eps,
                      weight_decay=weight_decay, mask=mask,
                      clip_norm=clip_norm, compute_dtype=compute_dtype)


def make_optimizer(lr: float | Callable[[int], float] = 1e-3, *,
                   optimizer: str = "adam", b1: float = 0.9,
                   b2: float | None = None, eps: float = 1e-8,
                   weight_decay: float = 0.0, clip_norm: float | None = None,
                   skip_nonfinite_updates: bool = False, fused: bool = False,
                   compute_dtype: torch.dtype | None = None) -> Adam:
    """Defaults reproduce the reference's ``Adam(lr=1e-3)``.
    ``weight_decay > 0`` is decoupled decay (AdamW) masked off 1-D params;
    ``clip_norm`` clips by the global norm first; ``fused=True`` builds
    :func:`fused_adamw` (``compute_dtype`` keeps its compute copy).
    Other optimizers and ``skip_nonfinite_updates`` are not ported yet
    (ROADMAP Queue 1 #2)."""
    if optimizer != "adam":
        raise NotImplementedError(
            f"optimizer={optimizer!r} is not ported yet (ROADMAP Queue 1 #2); "
            "the port has adam/adamw")
    if skip_nonfinite_updates:
        raise NotImplementedError(
            "skip_nonfinite_updates (--amp) is not ported yet "
            "(ROADMAP Queue 1 #2)")
    b2 = 0.999 if b2 is None else b2
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              mask=decay_mask if weight_decay > 0.0 else None,
              clip_norm=clip_norm)
    if fused:
        return fused_adamw(lr, compute_dtype=compute_dtype, **kw)
    return Adam(lr, **kw)
