"""Counter-based random streams for the training step.

JAX keys a stream by folding integers into a key (``fold_in``); the same
key gives the same bits wherever it is drawn, which is what lets a
checkpointed region draw its dropout masks again on recompute and lets
every microbatch and step draw fresh ones. JAX's threefry bits cannot be
reproduced here, so the port keeps the contract instead: a key is a
64-bit integer, :func:`fold_in` mixes integers into it (splitmix64), and
:func:`generator` seeds a fresh ``torch.Generator`` on a device from it at
the moment of the draw. Nothing is shared between draws, so a recompute
under ``torch.utils.checkpoint`` (which restores the global RNG state but
not an explicit generator's) draws what the first pass drew.
"""

from __future__ import annotations

import torch

_M64 = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64's finalizer of ``z + golden ratio``."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def fold_in(key: int, *data: int) -> int:
    """``key`` with each of ``data`` mixed in, in order: a new 64-bit key
    (the port's ``jax.random.fold_in``)."""
    key &= _M64
    for d in data:
        key = _mix(key ^ _mix(int(d) & _M64))
    return key


def generator(key: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``key`` (a CPU one
    for the meta device, whose draws fill nothing)."""
    if torch.device(device).type == "meta":
        device = "cpu"
    return torch.Generator(device=device).manual_seed(key)
