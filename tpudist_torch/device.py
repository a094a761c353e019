"""Device resolution for the PyTorch port.

Every entry point of :mod:`tpudist_torch` (``GPT2``, ``generate``,
``ServeEngine``, the serve CLI) runs on the card unless its caller asks
for the CPU. Nothing carries on silently on the CPU: without CUDA,
:func:`resolve_device` raises unless ``"cpu"`` was asked for by name.
"""

from __future__ import annotations

import torch

# fp32 parity with the JAX reference: its f32 matmuls run in full f32 on
# the CPU oracle, while PyTorch would route f32 convolutions (cuDNN) and,
# if a caller flipped it, f32 matmuls through TF32 (about three decimal
# digits). Pin both off so an f32 run of the port computes what the
# reference computes.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a card raises;
    ``"cpu"`` is honoured only when asked for explicitly, as is ``"meta"``
    (shapes without storage: :func:`tpudist_torch.memory.train_state_budget`
    builds a model there to count its bytes)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpudist_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain CPU path"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
