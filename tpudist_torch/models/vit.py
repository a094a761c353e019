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
``dropout_key`` (:func:`tpudist_torch.models.gpt2.dropout`).

Under a layout with a tensor axis (``layout=``, or the reference's
``mesh=`` as a :class:`tpudist_torch.mesh.RankLayout` or a
:class:`~tpudist_torch.mesh.MeshConfig`; :mod:`tpudist_torch.parallel.tp`)
each rank holds ``num_heads / T`` heads, as the reference's
``nn.with_partitioning`` annotations place them: ``qkv`` (its ``(3, H,
dh)`` out features and bias split by heads) and ``mlp.fc`` are
column-parallel, ``out`` and ``mlp.proj`` row-parallel (a rank's partial
product summed over the tensor group, the bias added once after the sum),
and the patch embedding, ``cls``, ``pos_embedding``, the LayerNorms and
the f32 head stay whole, on whole rows. The init draws every leaf whole
from the seeded generator, then keeps this rank's shard, so a sharded
model computes the unsharded one's function.
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
from tpudist_torch.parallel import tp as tp_lib
from tpudist_torch.parallel.tp import ColumnParallel, RowParallel, tensor_size

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
    dtype (column- then row-parallel under a tensor axis)."""

    def __init__(self, dim: int, mlp_dim: int, *, device=None, layout=None):
        super().__init__()
        self.fc = ColumnParallel(dim, mlp_dim, device=device, layout=layout)
        self.proj = RowParallel(mlp_dim, dim, device=device, layout=layout)

    def forward(self, x):
        return self.proj(F.gelu(self.fc(x), approximate="tanh"))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, *, dtype,
                 attn_impl: str, device=None, dropout: float = 0.0,
                 layout=None):
        super().__init__()
        self.dropout = dropout
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.layout = layout
        t = tensor_size(layout)
        self.ln_0 = LayerNorm(dim, eps=LN_EPS, device=device)
        # out features ordered (3, heads, dh); the bias keeps that shape. A
        # tensor rank holds its heads of each of q, k and v
        self.qkv = ColumnParallel(
            dim, 3 * dim, bias_shape=(3, num_heads // t, dim // num_heads),
            device=device, layout=layout)
        # in features ordered (heads, dh)
        self.out = RowParallel(dim, dim, device=device, layout=layout)
        self.ln_1 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp = MlpBlock(dim, mlp_dim, device=device, layout=layout)

    def forward(self, x, fused_ln: bool = False, dropout_key: int | None = None):
        b, s, d = x.shape
        dh = d // self.num_heads
        # this rank's heads (all of them without a tensor axis)
        h = self.num_heads // tensor_size(self.layout)
        y = self.ln_0.fused(x, self.dtype) if fused_ln else self.ln_0(x, self.dtype)
        qkv = self.qkv(y).view(b, s, 3, h, dh)
        q, k, v = qkv.unbind(2)
        attn = multi_head_attention(q, k, v, causal=False, impl=self.attn_impl)
        y = dropout(self.out(attn.reshape(b, s, h * dh)), self.dropout,
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
    device gets the same weights. ``layout`` (or the reference's ``mesh``,
    a layout or a ``MeshConfig``) lays the blocks out over its tensor
    axis (module docstring)."""

    tensor_specs = tp_lib.VIT_SPECS

    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 hidden_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, dtype=torch.float32,
                 attn_impl: str = "xla", dropout: float = 0.0, mesh=None, *,
                 image_size: int = 224, fused_ln: bool = False, device=None,
                 seed: int = 0, layout=None):
        super().__init__()
        layout = resolve_layout(mesh, layout)
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
        self.layout = layout
        tp_lib.check_model(self, tensor_size(layout))
        n_tokens = (image_size // patch_size) ** 2 + 1
        dev = self.device
        self.embedding = PatchEmbedding(hidden_dim, patch_size, device=dev)
        self.cls = nn.Parameter(torch.zeros(1, 1, hidden_dim, device=dev))
        self.pos_embedding = nn.Parameter(
            torch.empty(1, n_tokens, hidden_dim, device=dev))
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden_dim, num_heads, mlp_dim, dtype=dtype,
                         attn_impl=attn_impl, device=dev, dropout=self.dropout,
                         layout=layout)
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

        def lecun(name, p, fan_in):
            def draw(shape):
                t = torch.empty(shape)
                nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
                return t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)
            tp_lib.init_sharded(p, name, draw, self.layout, None,
                                table=self.tensor_specs)

        d, ps = self.hidden_dim, self.patch_size
        lecun("embedding.weight", self.embedding.weight, ps * ps * 3)
        self.embedding.bias.zero_()
        self.cls.zero_()
        self.pos_embedding.copy_(torch.randn(self.pos_embedding.shape,
                                             generator=g) * 0.02)
        for i, blk in enumerate(self.blocks):
            for name, lin, fan_in in (
                    ("qkv", blk.qkv, d), ("out", blk.out, d),
                    ("mlp.fc", blk.mlp.fc, d),
                    ("mlp.proj", blk.mlp.proj, self.mlp_dim)):
                lecun(f"blocks.{i}.{name}.weight", lin.weight, fan_in)
                lin.bias.zero_()
            for ln in (blk.ln_0, blk.ln_1):
                ln.scale.fill_(1.0)
                ln.bias.zero_()
        self.norm.scale.fill_(1.0)
        self.norm.bias.zero_()
        lecun("head.weight", self.head.weight, d)
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


def resolve_layout(mesh, layout):
    """The model's layout from the reference's ``mesh=`` (a
    :class:`~tpudist_torch.mesh.RankLayout`, or a
    :class:`~tpudist_torch.mesh.MeshConfig` laid out here: every rank
    calls it, in the same order) or the port's ``layout=``."""
    if mesh is None:
        return layout
    if layout is not None:
        raise ValueError("pass mesh= or layout=, not both")
    from tpudist_torch.mesh import MeshConfig, RankLayout, create_layout

    if isinstance(mesh, RankLayout):
        return mesh
    if isinstance(mesh, MeshConfig):
        return create_layout(mesh)
    raise TypeError(f"mesh= takes a RankLayout or a MeshConfig (the port's "
                    f"counterparts of a jax Mesh), got {type(mesh).__name__}")


def vit_b16(**kw) -> ViT:
    return ViT(**kw)
