"""tpudist_torch: the PyTorch / CUDA (Hopper) port of :mod:`tpudist`.

The JAX package stays the reference; this package keeps its module layout
and names so each counterpart is found at the same path
(``tpudist.ops.decode`` -> ``tpudist_torch.ops.decode``). It imports
``torch`` and numpy and never JAX or anything of ``tpudist``. Every
Pallas kernel on a ported path has a hand-written Hopper kernel under
``tpudist_torch/csrc`` with a plain PyTorch version beside it.

Ported so far: GPT-2 serving (paged and contiguous ``ServeEngine``,
``generate``) through the two decode-attention kernels; ResNet
data-parallel training (``python -m tpudist_torch.main``) through the
fused-AdamW kernel; GPT-2 training (``python -m tpudist_torch.train_gpt2``)
through the fused residual-add + LayerNorm and whole-row attention
kernels, forward and backward, and the fused-AdamW kernel, and at S 4096
through the flash-attention kernels; ViT-B/16 training (``python -m
tpudist_torch.main --model vit_b16``) through the LayerNorm and fused-AdamW
kernels, with ``--amp``, ``--grad_accum`` and the sgd / lamb / lion / muon
optimizers.
"""

from tpudist_torch.device import resolve_device

__all__ = ["resolve_device"]
