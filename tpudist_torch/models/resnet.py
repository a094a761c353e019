"""ResNet-18...152, computing what :mod:`tpudist.models.resnet` computes.

The public forward takes NHWC images, as the reference and the loader
do, and permutes them once to NCHW; on the card the permuted view is
already channels-last in memory, and the weights are kept channels-last
too. Four details of the flax model decide the function and are kept:

- **SAME padding.** flax pads ``(total // 2, total - total // 2)`` where
  ``total = max((ceil(n/s) - 1)*s + k - n, 0)``: asymmetric for a stride-2
  window on an even input (the 7x7/s2 stem pads (2, 3), a 3x3/s2 conv
  (0, 1), the 3x3/s2 max-pool (0, 1) with -inf). Torch's symmetric
  ``padding=`` would shift the window by a pixel, so asymmetric cases are
  padded explicitly and convolved or pooled with no padding.
- **flax BatchNorm(momentum=0.9, epsilon=1e-5).** Statistics in float32
  even at a bf16 compute dtype, ``var = E[x^2] - E[x]^2`` (clipped at 0),
  the running averages updated as ``0.9 * ra + 0.1 * batch`` with the
  BIASED batch variance (torch's ``BatchNorm2d`` uses the unbiased one).
  Under a ``torch.distributed`` process group the statistics are taken
  over the global batch: ``(sum x, sum x^2, count)`` are all-reduced with
  the autograd-aware ``torch.distributed.nn.functional.all_reduce``, so the
  backward sees the global batch too (the reference's SyncBatchNorm;
  ``torch.nn.SyncBatchNorm`` refuses CPU tensors under a group).
- **Precision.** Convs and BN outputs run in ``dtype``; BN statistics and
  the head ``Dense`` run in float32; the global pool is a mean over H, W.
  Parameters may be float32 masters (cast per op, as flax casts) or the
  fused optimizer's compute copy (the cast is then a no-op).
- **Init.** flax's: lecun-normal (truncated normal, fan-in) conv and head
  kernels, zero head bias, BN scale 1 and bias 0, drawn on the CPU from
  a ``torch.Generator`` seeded with ``seed`` and then moved, so every rank
  and device gets the same weights from the same seed.

The reference keeps the 1000-way head on CIFAR (main.py), so
``num_classes`` defaults to 1000 here too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.device import resolve_device
from tpudist_torch.distributed import group_up


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA ``padding="SAME"`` for one spatial dim of size ``n``."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """Pad NCHW ``x`` for a SAME ``k``x``k`` window of stride ``s``; returns
    ``(x, symmetric_padding)``: the padding left for the op to apply when
    both dims pad symmetrically, else 0 with ``x`` padded here."""
    (th, bh), (lw, rw) = (same_pads(x.shape[2], k, s),
                          same_pads(x.shape[3], k, s))
    if th == bh == lw == rw:
        return x, th
    return F.pad(x, (lw, rw, th, bh), value=value), 0


def max_pool_same(x, k: int = 3, s: int = 2):
    """flax ``nn.max_pool(x, (k, k), strides=(s, s), padding="SAME")`` on
    NCHW: the pad is -inf, so it never wins the max."""
    x, sym = _pad_same(x, k, s, value=float("-inf"))
    if sym:
        x = F.pad(x, (sym, sym, sym, sym), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    # flax lecun_normal: variance_scaling(1, fan_in, truncated_normal) —
    # a normal truncated at two standard deviations, rescaled so the
    # truncated distribution has variance 1 / fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), (s, s), use_bias=False,
    padding="SAME", dtype=dtype)``; weight ``[out, in, k, k]``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, *,
                 dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(
            _lecun_normal_(torch.empty(cout, cin, k, k), cin * k * k, gen))

    def forward(self, x):
        x, sym = _pad_same(x, self.k, self.stride)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=sym)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)`` over
    the batch and spatial dims of NCHW, cross-replica under a process
    group (module docstring). Parameters ``scale``/``bias``; running
    statistics in the buffers ``mean``/``var``. ``cross_replica = False``
    (the explicit reducer's path, :mod:`tpudist_torch.parallel.dp`) takes
    this rank's batch statistics, the DDP default."""

    cross_replica = True

    def __init__(self, features: int, *, dtype: torch.dtype,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        # statistics and the affine run in at least float32 (flax's rule)
        self.stat_dtype = torch.promote_types(dtype, torch.float32)
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def batch_stats(self, x):
        """``(mean, var)`` over the global batch, in ``stat_dtype``."""
        x32 = x.to(self.stat_dtype)
        c = x.shape[1]
        count = torch.full((c,), float(x32.numel() // c), device=x.device,
                           dtype=self.stat_dtype)
        sums = torch.stack([x32.sum((0, 2, 3)), torch.square(x32).sum((0, 2, 3)),
                            count])
        if group_up() and self.cross_replica:
            import torch.distributed as dist
            from torch.distributed.nn.functional import all_reduce

            # the group named at each call: some torch releases bind the
            # default group when the module is first imported, and a later
            # process group (a new world in the same process) would then
            # reach a destroyed one
            sums = all_reduce(sums, group=dist.group.WORLD)
        mean = sums[0] / sums[2]
        var = torch.clamp(sums[1] / sums[2] - torch.square(mean), min=0.0)
        return mean, var

    def forward(self, x):
        if self.training:
            mean, var = self.batch_stats(x)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean
                                + (1.0 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var
                               + (1.0 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        shape = (1, -1, 1, 1)
        sd = self.stat_dtype
        mul = torch.rsqrt(var + self.eps) * self.scale.to(sd)
        y = (x.to(sd) - mean.reshape(shape)) * mul.reshape(shape)
        return (y + self.bias.to(sd).reshape(shape)).to(self.dtype)


class ResNetBlock(nn.Module):
    """Basic 3x3 + 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, *, dtype, gen):
        super().__init__()
        self.conv0 = Conv(cin, filters, 3, stride, dtype=dtype, gen=gen)
        self.bn0 = BatchNorm(filters, dtype=dtype)
        self.conv1 = Conv(filters, filters, 3, dtype=dtype, gen=gen)
        self.bn1 = BatchNorm(filters, dtype=dtype)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or cin != filters:
            self.conv_proj = Conv(cin, filters, 1, stride, dtype=dtype, gen=gen)
            self.norm_proj = BatchNorm(filters, dtype=dtype)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck block (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, *, dtype, gen):
        super().__init__()
        out = filters * 4
        self.conv0 = Conv(cin, filters, 1, dtype=dtype, gen=gen)
        self.bn0 = BatchNorm(filters, dtype=dtype)
        self.conv1 = Conv(filters, filters, 3, stride, dtype=dtype, gen=gen)
        self.bn1 = BatchNorm(filters, dtype=dtype)
        self.conv2 = Conv(filters, out, 1, dtype=dtype, gen=gen)
        self.bn2 = BatchNorm(out, dtype=dtype)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or cin != out:
            self.conv_proj = Conv(cin, out, 1, stride, dtype=dtype, gen=gen)
            self.norm_proj = BatchNorm(out, dtype=dtype)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``stage_sizes`` blocks of ``block_cls`` per stage; filters
    ``num_filters * 2**stage``. ``stem``: ``"conv7"`` (torchvision's 7x7/s2
    conv + 3x3/s2 max-pool) or ``"space_to_depth"`` (2x2 space-to-depth,
    then a 4x4/s1 conv); ``small_inputs``: the CIFAR stem, one 3x3/s1 conv
    and no max-pool. Runs on ``resolve_device(device)``: the card unless
    the caller asks for ``"cpu"``."""

    def __init__(self, stage_sizes, block_cls, *, num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.float32,
                 small_inputs: bool = False, stem: str = "conv7",
                 device=None, seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        if stem not in ("conv7", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}")
        if small_inputs and stem != "conv7":
            raise ValueError(
                f"stem={stem!r} has no effect with small_inputs (the CIFAR "
                "stem is a single 3x3/s1 conv)")
        self.dtype, self.small_inputs, self.stem = dtype, small_inputs, stem
        gen = torch.Generator(device="cpu").manual_seed(seed)
        if small_inputs:
            self.conv_init = Conv(3, num_filters, 3, dtype=dtype, gen=gen)
        elif stem == "space_to_depth":
            self.conv_init_s2d = Conv(12, num_filters, 4, dtype=dtype, gen=gen)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, dtype=dtype, gen=gen)
        self.bn_init = BatchNorm(num_filters, dtype=dtype)
        blocks, cin = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                blocks.append(block_cls(cin, filters, stride, dtype=dtype,
                                        gen=gen))
                cin = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)
        with torch.no_grad():
            _lecun_normal_(self.head.weight, cin, gen)
            self.head.bias.zero_()
        self.to(self.device)
        if self.device.type == "cuda":
            # channels-last weights for cuDNN's NHWC kernels; a 1x1 weight
            # is laid out the same either way, and keeping its contiguous
            # strides keeps them equal to its gradient's (which DDP checks)
            for m in self.modules():
                if isinstance(m, Conv) and m.k > 1:
                    m.weight.data = m.weight.data.contiguous(
                        memory_format=torch.channels_last)

    def forward(self, x):
        """``x``: NHWC images ``[N, H, W, 3]`` -> float32 logits."""
        if self.stem == "space_to_depth" and not self.small_inputs:
            n, h, w, c = x.shape
            if h % 2 or w % 2:
                raise ValueError(
                    f"space_to_depth stem needs even H/W, got {(h, w)}")
            x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(n, h // 2, w // 2, 4 * c)
        x = x.permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last) if x.is_cuda \
            else x.contiguous()
        x = x.to(self.dtype)
        stem = self.conv_init_s2d if hasattr(self, "conv_init_s2d") \
            else self.conv_init
        x = F.relu(self.bn_init(stem(x)))
        if not self.small_inputs:
            x = max_pool_same(x)
        for block in self.blocks:
            x = block(x)
        x = x.mean((2, 3))
        # flax Dense(dtype=float32): the head computes in float32 whatever
        # the model's dtype
        return F.linear(x.float(), self.head.weight.float(),
                        self.head.bias.float())


def resnet18(**kw) -> ResNet:
    return ResNet([2, 2, 2, 2], ResNetBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet([3, 4, 6, 3], ResNetBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet([3, 4, 6, 3], BottleneckBlock, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet([3, 4, 23, 3], BottleneckBlock, **kw)


def resnet152(**kw) -> ResNet:
    return ResNet([3, 8, 36, 3], BottleneckBlock, **kw)
