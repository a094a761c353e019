"""Named rematerialization policies: the port of :mod:`tpudist.remat`.

The reference's policies on ``torch.utils.checkpoint`` (non-reentrant):

===============  ============================================================
``save_nothing`` save no intermediates: a selective-checkpoint policy that
                 recomputes every op (the floor)
``full``         plain ``checkpoint`` (also saves nothing; the legacy
                 ``remat=True`` spelling)
``dots_saveable``save the matrix products' outputs (``aten.mm``, ``addmm``,
                 ``bmm``, ``baddbmm``, ``_scaled_mm``), recompute the rest
``none``         no checkpointing
===============  ============================================================

Two hooks consume them, as in the reference:
``make_train_step(remat=...)`` checkpoints the model's whole forward
(:func:`remat_module`), and GPT-2's and Llama's ``remat_policy`` field
checkpoints each block (:func:`checkpoint`). The port's hand-written kernels are bound
through ``ctypes`` and launched on raw pointers, so a selective policy's
dispatch mode never sees them: they are always recomputed, and their
outputs, allocated with ``torch.empty`` (which no policy here saves), are
fresh buffers on recompute. A raw selective-checkpoint policy function
``(ctx, op, *args, **kwargs) -> CheckpointPolicy`` is accepted in place of
a name, as the reference accepts a ``jax.checkpoint_policies`` callable.
"""

from __future__ import annotations

import functools
import types
from typing import Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint as _checkpoint,
    create_selective_checkpoint_contexts,
)

_aten = torch.ops.aten
#: the matrix products whose outputs ``dots_saveable`` keeps
DOTS = frozenset({_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
                  _aten._scaled_mm})


def dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Keep the products' outputs, recompute everything else."""
    if op.overloadpacket in DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def nothing_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Recompute every op."""
    return CheckpointPolicy.PREFER_RECOMPUTE


# name -> selective policy (None = plain checkpoint, which saves nothing).
# "none" is absent on purpose: it means "do not wrap".
_POLICIES = {
    "full": None,
    "save_nothing": nothing_saveable,
    "dots_saveable": dots_saveable,
}

POLICY_NAMES = ("none", "full", "dots_saveable", "save_nothing")


def resolve(policy: str | bool | None | Callable):
    """Normalize a remat policy argument.

    Returns ``None`` for "no remat" (``False``/``None``/``"none"``), else a
    dict of keyword arguments for ``torch.utils.checkpoint.checkpoint``.
    Accepts the legacy bool (``True`` == ``"full"``), a policy name, or a
    raw selective-checkpoint policy function."""
    if policy in (False, None, "none"):
        return None
    if policy is True:
        policy = "full"
    if callable(policy):
        fn = policy
    else:
        try:
            fn = _POLICIES[policy]
        except (KeyError, TypeError):
            raise ValueError(
                f"unknown remat policy {policy!r}; expected one of "
                f"{POLICY_NAMES}, a bool, or a selective-checkpoint policy "
                "function"
            ) from None
    if fn is None:
        return {}
    return {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, fn)}


def checkpoint(fn: Callable, policy: str | bool | None | Callable) -> Callable:
    """``fn`` checkpointed under the named policy (non-reentrant; keyword
    arguments pass through); ``fn`` unchanged for ``"none"``. With autograd
    off (evaluation, decode) the wrapper calls ``fn`` directly."""
    kwargs = resolve(policy)
    if kwargs is None:
        return fn

    def run(*args, **kw):
        if not torch.is_grad_enabled():
            return fn(*args, **kw)
        return _checkpoint(fn, *args, use_reentrant=False, **kwargs, **kw)

    return run


def _checkpointed_forward(self, *args, **kwargs):
    forward = functools.partial(type(self).forward, self)
    return checkpoint(forward, self._remat)(*args, **kwargs)


def remat_module(module: torch.nn.Module,
                 policy: str | bool | None | Callable) -> torch.nn.Module:
    """Checkpoint ``module``'s forward under ``policy`` (in place, and
    returned); ``"none"`` restores the plain forward. The hook goes on the
    module itself, inside any ``DistributedDataParallel`` around it, so
    the recompute runs the module's forward and never DDP's."""
    module.__dict__.pop("forward", None)
    module._remat = policy
    if resolve(policy) is not None:
        module.forward = types.MethodType(_checkpointed_forward, module)
    return module
