"""Mixed-precision policy.

Counterpart of :class:`tpudist.amp.Policy`: "float32 master parameters,
bf16 compute, float32 logits/loss". The port's modules implement it the
way the flax ones do: parameters are float32 and each layer casts them to
its ``dtype``; the head and the loss run in float32. ``--bf16`` selects
:data:`BF16_COMPUTE`. The non-finite update guard (``skip_nonfinite``,
``--amp``) is not ported yet (ROADMAP Queue 1 #2).
"""

from __future__ import annotations

import dataclasses

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
