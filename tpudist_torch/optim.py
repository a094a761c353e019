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

    def __init__(self, learning_rate: float | Callable[[int], float] = 1e-3,
                 *, weight_decay: float = 0.0,
                 mask: Callable[[dict], dict] | None = None,
                 clip_norm: float | None = None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.mask = mask
        self.clip_norm = clip_norm

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

    def _grads(self, grads: dict) -> dict:
        if self.clip_norm is not None:
            return clip_by_global_norm(grads, self.clip_norm)
        return grads

    @torch.no_grad()
    def step(self, state, params: dict, grads: dict, *, guard: bool = False):
        """One update of every parameter in ``params``, in place. With
        ``guard`` the update is written only where every gradient is
        finite, and the step returns the device flag (true: skipped); it
        counts the step as taken either way."""
        ok = all_finite(grads) if guard else None
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
        if self.compute_dtype is None:
            master = dict(params)
        else:
            master = {k: p.detach().float().clone() for k, p in params.items()}
            for p in params.values():
                if p.is_floating_point():
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
        flag = None
        if guard:
            flag = state.nonfinite
            FU.nonfinite_check(state.table, [grads[k] for k in state.names],
                               flag)
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
        return MomentState(0, _zeros(params))

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
        return MomentState(0, _zeros(params))

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

    def __init__(self, learning_rate=1e-3, *, beta: float = 0.95,
                 eps: float = 1e-8, weight_decay=0.0, mask=None,
                 adam_b1: float = 0.9, adam_b2: float = 0.999,
                 clip_norm=None):
        super().__init__(learning_rate, weight_decay=weight_decay, mask=mask,
                         clip_norm=clip_norm)
        self.beta, self.eps = beta, eps
        self.adam_b1, self.adam_b2 = adam_b1, adam_b2

    def init(self, params: dict) -> MuonState:
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
