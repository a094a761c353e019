"""tpudist_torch: the PyTorch / CUDA (Hopper) port of :mod:`tpudist`.

The JAX package stays the reference; this package keeps its module layout
and names so each counterpart is found at the same path
(``tpudist.ops.decode`` -> ``tpudist_torch.ops.decode``). It imports
``torch`` and numpy and never JAX or anything of ``tpudist``. Every
Pallas kernel on a ported path has a hand-written Hopper kernel under
``tpudist_torch/csrc`` with a plain PyTorch version beside it.

Ported so far: GPT-2 serving (paged and contiguous ``ServeEngine``,
``generate``) through the two decode-attention kernels.
"""

from tpudist_torch.device import resolve_device

__all__ = ["resolve_device"]
