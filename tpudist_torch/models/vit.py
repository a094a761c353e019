"""ViT-B/16 in PyTorch: counterpart of :mod:`tpudist.models.vit`.

BASELINE.json's configuration 4 (ViT-B/16, data-parallel, bf16), which
``python -m tpudist_torch.main --model vit_b16`` trains. The forward
takes NHWC images, as the reference and the loader do, and computes
what the flax model computes at ``dtype``:

- **patch embedding**: flax's ``Conv((p, p), strides=p, VALID)`` as a
  strided ``F.conv2d`` (weight ``[768, 3, p, p]``, the reference's HWIO
  kernel transposed), its bias added after the product in ``dtype``;
- **cls and pos**: float32 parameters cast to ``dtype`` before the concat
  and the add;
- **encoder blocks**: pre-norm, flax ``LayerNorm(epsilon=1e-6)`` (f32
  statistics, fast variance; the port's :class:`LayerNorm`), ``qkv``
  ``[768 -> (3, H, dh)]`` (bias ``[3, H, dh]``), attention by
  ``attn_impl`` (``"xla"``, the reference's default and ``main.py``'s
  path: the dense attention; ``"vmem"``/``"auto"``: the whole-row kernel
  through :func:`tpudist_torch.ops.attention.multi_head_attention`),
  non-causal, ``out`` ``[(H, dh) -> 768]``, and an MLP with the tanh GELU
  (flax ``nn.gelu``'s default);
- **head**: flax ``Dense(num_classes, dtype=float32)`` on the upcast cls
  row: float32 logits whatever ``dtype``.

``fused_ln`` (an attribute, which ``make_train_step(fused="ln")`` sets)
swaps in the fused LayerNorm kernel (:mod:`tpudist_torch.ops.layernorm`,
eps 1e-6) where the reference's knob does: each block's first norm plain,
its second the pre-norm composition ``(n, x + y) = ln(y, residual=x)``,
the final norm plain; 25 forward and 25 backward launches at ViT-B's
depth. The parameters are the same either way.

Every parameter is a float32 master cast to ``dtype`` at each use, as
flax casts (under the fused optimizer's compute copy the parameters
already are ``dtype`` and the casts are no-ops). ``dropout`` is the
reference's residual dropout, on each block's two branches before their
adds (no embedding dropout), with masks from the training step's
``dropout_key`` (:func:`tpudist_torch.models.gpt2.dropout`). ``mesh`` of
the reference is not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.device import resolve_device
from tpudist_torch.models.gpt2 import (
    _TRUNC_STD, Dense, LayerNorm, dropout, site_key, train_key,
)
from tpudist_torch.ops.attention import multi_head_attention

ATTN_IMPLS = ("xla", "vmem", "auto")
LN_EPS = 1e-6


class PatchEmbedding(nn.Module):
    """The patch projection's parameters: ``weight [dim, 3, p, p]`` (the
    reference's ``[p, p, 3, dim]`` kernel transposed) and ``bias``."""

    def __init__(self, dim: int, patch_size: int, *, device=None):
        super().__init__()
        p = patch_size
        self.weight = nn.Parameter(torch.empty(dim, 3, p, p, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))


class MlpBlock(nn.Module):
    """``Dense(mlp_dim)`` -> tanh GELU -> ``Dense(dim)``, in the input's
    dtype."""

    def __init__(self, dim: int, mlp_dim: int, *, device=None):
        super().__init__()
        self.fc = Dense(dim, mlp_dim, device=device)
        self.proj = Dense(mlp_dim, dim, device=device)

    def forward(self, x):
        return self.proj(F.gelu(self.fc(x), approximate="tanh"))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, *, dtype,
                 attn_impl: str, device=None, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.ln_0 = LayerNorm(dim, eps=LN_EPS, device=device)
        # out features ordered (3, heads, dh); the bias keeps that shape
        self.qkv = Dense(dim, 3 * dim,
                         bias_shape=(3, num_heads, dim // num_heads),
                         device=device)
        self.out = Dense(dim, dim, device=device)  # in features (heads, dh)
        self.ln_1 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp = MlpBlock(dim, mlp_dim, device=device)

    def forward(self, x, fused_ln: bool = False, dropout_key: int | None = None):
        b, s, d = x.shape
        h = self.num_heads
        y = self.ln_0.fused(x, self.dtype) if fused_ln else self.ln_0(x, self.dtype)
        qkv = self.qkv(y).view(b, s, 3, h, d // h)
        q, k, v = qkv.unbind(2)
        attn = multi_head_attention(q, k, v, causal=False, impl=self.attn_impl)
        y = dropout(self.out(attn.reshape(b, s, d)), self.dropout,
                    site_key(dropout_key, 0))
        if fused_ln:
            # the residual add and the norm in one kernel sweep
            y, x = self.ln_1.fused(y, self.dtype, residual=x)
        else:
            x = x + y
            y = self.ln_1(x, self.dtype)
        return x + dropout(self.mlp(y), self.dropout, site_key(dropout_key, 1))


class ViT(nn.Module):
    """The reference's ``ViT`` with its defaults (ViT-B/16: 1000 classes,
    16-pixel patches, width 768, depth 12, 12 heads, MLP 3072) for
    ``image_size``-pixel square inputs. ``device`` defaults to
    ``"cuda"`` and raises without a card unless ``"cpu"`` is given;
    ``seed`` draws the random init (flax's distributions: lecun-normal
    kernels, zero biases and cls, N(0, 0.02) positions, unit LayerNorm
    scales) from a ``torch.Generator`` on the CPU, so every rank and
    device gets the same weights."""

    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 hidden_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, dtype=torch.float32,
                 attn_impl: str = "xla", dropout: float = 0.0, mesh=None, *,
                 image_size: int = 224, fused_ln: bool = False, device=None,
                 seed: int = 0):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError(
                "ViT over a mesh is not ported yet (ROADMAP Queue 1 #7b "
                "(remainder): the LMs' tensor layers are ported)")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}")
        if hidden_dim % num_heads:
            raise ValueError("hidden_dim must divide into num_heads")
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"patch_size {patch_size}")
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.patch_size = patch_size
        self.hidden_dim = hidden_dim
        self.depth = depth
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.dropout = float(dropout)
        self.fused_ln = bool(fused_ln)
        n_tokens = (image_size // patch_size) ** 2 + 1
        dev = self.device
        self.embedding = PatchEmbedding(hidden_dim, patch_size, device=dev)
        self.cls = nn.Parameter(torch.zeros(1, 1, hidden_dim, device=dev))
        self.pos_embedding = nn.Parameter(
            torch.empty(1, n_tokens, hidden_dim, device=dev))
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden_dim, num_heads, mlp_dim, dtype=dtype,
                         attn_impl=attn_impl, device=dev, dropout=self.dropout)
            for _ in range(depth))
        self.norm = LayerNorm(hidden_dim, eps=LN_EPS, device=dev)
        self.head = Dense(hidden_dim, num_classes, device=dev)
        self.init_weights(seed)

    @property
    def flops_counter(self) -> str | None:
        """Analytic-FLOPs family tag, as the reference's: ``"vit"`` for
        the standard 4 x width MLP, else None."""
        return "vit" if self.mlp_dim == 4 * self.hidden_dim else None

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = torch.Generator().manual_seed(int(seed))

        def lecun(p, fan_in):
            t = torch.empty(p.shape)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
            p.copy_(t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))

        d, ps = self.hidden_dim, self.patch_size
        lecun(self.embedding.weight, ps * ps * 3)
        self.embedding.bias.zero_()
        self.cls.zero_()
        self.pos_embedding.copy_(torch.randn(self.pos_embedding.shape,
                                             generator=g) * 0.02)
        for blk in self.blocks:
            for lin, fan_in in ((blk.qkv, d), (blk.out, d), (blk.mlp.fc, d),
                                (blk.mlp.proj, self.mlp_dim)):
                lecun(lin.weight, fan_in)
                lin.bias.zero_()
            for ln in (blk.ln_0, blk.ln_1):
                ln.scale.fill_(1.0)
                ln.bias.zero_()
        self.norm.scale.fill_(1.0)
        self.norm.bias.zero_()
        lecun(self.head.weight, d)
        self.head.bias.zero_()

    def forward(self, x, dropout_key: int | None = None):
        """``x``: NHWC images ``[B, H, W, 3]`` -> float32 logits
        ``[B, num_classes]``. In train mode a model with ``dropout > 0``
        needs ``dropout_key`` (block ``i`` draws from site ``i``); in eval
        mode nothing is dropped."""
        dropout_key = train_key(self, dropout_key)
        dt = self.dtype
        # NCHW in memory, so the weight's gradient keeps the weight's layout
        x = x.permute(0, 3, 1, 2).to(dt).contiguous()
        # the product, then the bias in dtype (flax's two roundings)
        x = F.conv2d(x, self.embedding.weight.to(dt), stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2) + self.embedding.bias.to(dt)
        b = x.shape[0]
        x = torch.cat([self.cls.to(dt).expand(b, -1, -1), x], dim=1)
        if x.shape[1] != self.pos_embedding.shape[1]:
            raise ValueError(f"{x.shape[1]} tokens, the model was built for "
                             f"{self.pos_embedding.shape[1]} (image_size)")
        x = x + self.pos_embedding.to(dt)
        fused = self.fused_ln
        for i, blk in enumerate(self.blocks):
            x = blk(x, fused_ln=fused, dropout_key=site_key(dropout_key, i))
        x = self.norm.fused(x, dt) if fused else self.norm(x, dt)
        # flax Dense(dtype=float32): the head computes in float32
        return F.linear(x[:, 0].float(), self.head.weight.float(),
                        self.head.bias.float())


def vit_b16(**kw) -> ViT:
    return ViT(**kw)
