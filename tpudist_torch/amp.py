"""Mixed-precision policy and the non-finite update guard.

Counterpart of :mod:`tpudist.amp`: "float32 master parameters, bf16
compute, float32 logits/loss". The port's modules implement the policy
the way the flax ones do: parameters are float32 and each layer casts
them to its ``dtype``; the head and the loss run in float32. ``--bf16``
selects :data:`BF16_COMPUTE`, and so does ``--amp``, which also wraps the
optimizer in :func:`skip_nonfinite`.

:func:`skip_nonfinite` keeps the reference's semantics: on a step whose
gradients hold an inf or a NaN the parameters, the optimizer's moments
and its step count are left as they were and the skip counter rises by
one, so the next step's bias corrections and schedule value use the
count that was not advanced. The reference decides that inside its
compiled step; here the decision stays on the card: each optimizer, given
``guard=True``, computes a device flag from the gradients and writes
every state tensor through it (the fused AdamW kernel reads the flag and
writes nothing), and counts the step as taken. The wrapper copies the
flag to pinned host memory behind an event and reads it only at the next
step, after that step's forward and backward have been queued, so the
host waits on nothing; a set flag then takes the step back off the count
and adds one to the skip counter, before the next step's scalars are
built.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtype roles for a training step: ``param_dtype`` the masters,
    ``compute_dtype`` the forward/backward, ``output_dtype`` the logits
    and loss."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32


FP32 = Policy()
BF16_COMPUTE = Policy(compute_dtype=torch.bfloat16)


def policy_for(bf16: bool) -> Policy:
    return BF16_COMPUTE if bf16 else FP32


def _floats(tensors):
    if isinstance(tensors, dict):
        tensors = tensors.values()
    return [t for t in tensors if t.is_floating_point()]


def all_finite(tensors) -> torch.Tensor:
    """0-dim bool tensor: every element of every float tensor of
    ``tensors`` (a dict or a sequence) is finite. Stays on the tensors'
    device: nothing is read back."""
    flags = [torch.isfinite(t).all() for t in _floats(tensors)]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


def nonfinite_count(tensors) -> torch.Tensor:
    """0-dim int32 tensor: how many elements of the float tensors of
    ``tensors`` are non-finite (integer tensors cannot be)."""
    counts = [(~torch.isfinite(t)).sum() for t in _floats(tensors)]
    if not counts:
        return torch.zeros((), dtype=torch.int32)
    return torch.stack(counts).sum().to(torch.int32)


@dataclasses.dataclass
class SkipState:
    """:class:`SkipNonfinite`'s state: ``inner`` the wrapped optimizer's
    state, ``skipped`` the steps skipped so far (a host int, complete
    once :meth:`resolve` has run), ``pending`` the last step's flag in
    flight to the host (a pinned buffer and its event), or None."""

    inner: Any
    skipped: int = 0
    pending: tuple | None = None

    def resolve(self) -> None:
        """Read the last step's flag (waiting only for it) and, when that
        step was skipped, take it back off the inner count."""
        if self.pending is None:
            return
        buf, ready = self.pending
        self.pending = None
        if ready is not None:
            ready.synchronize()
        if bool(buf):
            self.skipped += 1
            self.inner.count -= 1

    def state_dict(self) -> dict:
        """``skipped`` and the inner state's entries, after :meth:`resolve`
        (a wait for the last step's flag), so both counts are exact."""
        self.resolve()
        return {"skipped": self.skipped, "inner": self.inner.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(sd["inner"])
        self.skipped = int(sd["skipped"])
        self.pending = None


class SkipNonfinite:
    """The reference's ``skip_nonfinite`` around a port optimizer:
    ``init``/``step`` as every optimizer of :mod:`tpudist_torch.optim`
    has them, with ``inner`` kept visible (``fused``/``compute_dtype``
    are the inner optimizer's, so the train step's capability probes see
    through the wrapper)."""

    def __init__(self, inner):
        self.inner = inner

    @property
    def fused(self) -> bool:
        return getattr(self.inner, "fused", False)

    @property
    def compute_dtype(self):
        return getattr(self.inner, "compute_dtype", None)

    def init(self, params: dict) -> SkipState:
        return SkipState(self.inner.init(params))

    @torch.no_grad()
    def step(self, state: SkipState, params: dict, grads: dict) -> None:
        state.resolve()
        skipped = self.inner.step(state.inner, params, grads, guard=True)
        cuda = skipped.is_cuda
        buf = torch.empty((), dtype=torch.bool, pin_memory=cuda)
        buf.copy_(skipped.reshape(()) != 0, non_blocking=True)
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record()
        state.pending = (buf, ready)


def skip_nonfinite(tx) -> SkipNonfinite:
    """Wrap an optimizer so steps with non-finite gradients become no-ops
    that are counted (module docstring)."""
    return SkipNonfinite(tx)


def is_skip_state(opt_state) -> bool:
    """True when ``opt_state`` is a :func:`skip_nonfinite` state (under
    ZeRO-1's, too)."""
    if hasattr(opt_state, "slices"):
        opt_state = opt_state.inner
    return isinstance(opt_state, SkipState)


def skipped_steps(opt_state: SkipState) -> int:
    """The skip counter of a :func:`skip_nonfinite` state, the last step's
    flag read first (this waits for that step)."""
    if hasattr(opt_state, "slices"):
        opt_state = opt_state.inner
    opt_state.resolve()
    return opt_state.skipped


def maybe_skipped_steps(opt_state) -> int | None:
    """:func:`skipped_steps`, or None when the state carries no skip
    wrapper."""
    return skipped_steps(opt_state) if is_skip_state(opt_state) else None


def inner_state(opt_state):
    """The wrapped optimizer's state under a :func:`skip_nonfinite` state
    and a ZeRO-1 state (:func:`tpudist_torch.optim.shard_state`), or
    ``opt_state`` itself."""
    while is_skip_state(opt_state) or hasattr(opt_state, "slices"):
        opt_state = opt_state.inner
    return opt_state
