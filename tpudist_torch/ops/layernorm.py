"""Fused residual-add + LayerNorm / RMSNorm, forward and backward.

Counterpart of :mod:`tpudist.ops.layernorm`. The kernels
(``tpudist_torch/csrc/layernorm.cu``) replace the Pallas ``_fwd_kernel``
(``_fwd_call``) and ``_bwd_kernel`` (``_bwd_call``): the forward computes
``r = x (+ y)`` in float32, the masked row mean and the direct variance
``E[(r - mu)^2]`` over the true width, and ``(r - mu) * rstd * scale
(+ bias)`` in one sweep, writing ``n`` in ``out_dtype`` and ``r`` in x's
dtype; the backward recomputes the statistics from the saved ``r`` and
writes ``dr`` plus float32 ``dscale``/``dbias`` (per-block partials and a
second, reducing launch: deterministic, no atomics; the column sums are
taken in float64 on both paths, see :func:`layernorm_bwd_plain`).

:func:`fused_layernorm` keeps the reference's three compositions, each a
``torch.autograd.Function`` whose backward is the kernel:

- plain: ``fused_layernorm(x, scale, bias)`` -> ``n``;
- pre-norm: ``fused_layernorm(x, scale, bias, residual=y)`` ->
  ``(n, r)``, ``r = x + y`` continuing the residual stream;
- post-norm: ``... return_residual=False`` -> ``n`` only (``r`` is still
  saved for the backward).

Because ``r = x + y`` is a plain add, ``dx = dy = dr`` (plus the
residual stream's own cotangent for pre-norm). ``rms=True`` is scale-only
RMSNorm. Unlike the reference there is no padding to a (8, 128) tile: the
kernel masks the row's tail itself.

Each wrapper takes the kernel for CUDA tensors and the plain PyTorch
version (:func:`layernorm_fwd_plain`, :func:`layernorm_bwd_plain`, the
same arithmetic op by op) only for CPU tensors. :data:`launch_counts`
counts kernel launches, the backward's two separately.
"""

from __future__ import annotations

import numpy as np
import torch

#: launches of the kernels, counted where the wrappers launch them and
#: nowhere else (the plain versions never count); one backward call
#: launches ``layernorm_bwd`` and then ``layernorm_bwd_reduce``
launch_counts = {"layernorm_fwd": 0, "layernorm_bwd": 0,
                 "layernorm_bwd_reduce": 0}

_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _inv_d(d: int) -> float:
    """``1 / D`` as the float32 the reference multiplies by."""
    return float(np.float32(1.0 / d))


def _row_stats(r, *, eps: float, rms: bool):
    """Per-row ``(mean, rstd)`` of float32 rows ``r [N, D]``: the mean,
    then the direct variance of the centred rows (RMS: mean 0, ``E[r^2]``)."""
    inv_d = _inv_d(r.shape[-1])
    if rms:
        mean = torch.zeros_like(r[:, :1])
        var = (r * r).sum(-1, keepdim=True) * inv_d
    else:
        mean = r.sum(-1, keepdim=True) * inv_d
        diff = r - mean
        var = (diff * diff).sum(-1, keepdim=True) * inv_d
    return mean, torch.rsqrt(var + eps)


def layernorm_fwd_plain(x, y, scale, bias, *, eps: float, rms: bool,
                        out_dtype, want_residual: bool):
    """The forward kernel's function in plain PyTorch. ``x``, ``y``:
    ``[N, D]``; ``scale``/``bias``: ``[D]`` (``bias`` None under ``rms``).
    Returns ``(n, r|None)``."""
    r = x.float()
    if y is not None:
        r = r + y.float()
    mean, rstd = _row_stats(r, eps=eps, rms=rms)
    n = (r - mean) * rstd * scale.float()
    if bias is not None:
        n = n + bias.float()
    res = r.to(x.dtype) if want_residual else None
    return n.to(out_dtype), res


def layernorm_bwd_plain(r, g, gr, scale, *, eps: float, rms: bool):
    """The backward kernels' function in plain PyTorch: from the saved
    ``r [N, D]``, the cotangent ``g`` of ``n`` and (pre-norm) ``gr`` of
    ``r``, returns ``(dr in r's dtype, dscale f32 [D], dbias f32 [D])``.
    The column sums over the rows run in float64 and round once: summed
    in float32, 8192 rows drift by ~1e-4 from the exact sums in an order
    that depends on the implementation (the reference sums in float32)."""
    rf, gf = r.float(), g.float()
    mean, rstd = _row_stats(rf, eps=eps, rms=rms)
    inv_d = _inv_d(r.shape[-1])
    xhat = (rf - mean) * rstd
    dxhat = gf * scale.float()
    c2 = (dxhat * xhat).sum(-1, keepdim=True) * inv_d
    dr = dxhat - xhat * c2
    if not rms:
        dr = dr - dxhat.sum(-1, keepdim=True) * inv_d
    dr = dr * rstd
    if gr is not None:
        dr = dr + gr.float()
    colsum = lambda t: t.double().sum(0).float()
    return dr.to(r.dtype), colsum(gf * xhat), colsum(gf)


def _check(what, rows, vecs, *, d=None):
    """Device, dtype, shape and contiguity checks of a CUDA launch."""
    dev = rows[0].device
    n, d = rows[0].shape if d is None else (rows[0].shape[0], d)
    for t in rows:
        if t is None:
            continue
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{what}: every tensor must be on {dev}")
        if t.dtype not in _CODE:
            raise ValueError(f"{what}: dtype {t.dtype} not in (float32, "
                             "bfloat16)")
        if t.shape != (n, d) or not t.is_contiguous():
            raise ValueError(f"{what}: rows must be contiguous [{n}, {d}], "
                             f"got {tuple(t.shape)} strides {t.stride()}")
    for t in vecs:
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float32 or t.shape != (d,) \
                or not t.is_contiguous():
            raise ValueError(f"{what}: scale/bias must be contiguous float32 "
                             f"[{d}] on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def layernorm_fwd_cuda(x, y, scale, bias, *, eps: float, rms: bool,
                       out_dtype, want_residual: bool, lib=None):
    """Launch the forward kernel on the current stream. ``x``/``y``:
    contiguous ``[N, D]`` of one dtype (float32 or bfloat16), ``D`` at most
    the kernel's 2048; ``scale``/``bias``: contiguous float32 ``[D]``.
    The kernel takes 16-byte loads where D is a multiple of 16 bytes and
    every pointer is 16-byte aligned, element-wise loads otherwise.
    ``lib``: a loaded build of another ``layernorm.cu`` (an A/B); this
    checkout's by default. Returns ``(n, r|None)``."""
    from tpudist_torch.csrc import build

    _check("layernorm_fwd", [x, y], [scale, bias])
    if y is not None and y.dtype != x.dtype:
        raise ValueError("layernorm_fwd: x and the residual differ in dtype")
    if out_dtype not in _CODE:
        raise ValueError(f"layernorm_fwd: out_dtype {out_dtype} not in "
                         "(float32, bfloat16)")
    n_rows, d = x.shape
    lib = lib or build.load("layernorm.cu")
    if d > lib.tpudist_layernorm_max_d():
        raise ValueError(f"layernorm_fwd: D {d} above the kernel's "
                         f"{lib.tpudist_layernorm_max_d()}")
    out = torch.empty((n_rows, d), dtype=out_dtype, device=x.device)
    res = torch.empty_like(x) if want_residual else None
    rc = lib.tpudist_layernorm_fwd(
        _CODE[x.dtype], _CODE[out_dtype], x.data_ptr(), _ptr(y),
        scale.data_ptr(), _ptr(bias), out.data_ptr(), _ptr(res), n_rows, d,
        _inv_d(d), eps, int(rms),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "layernorm_fwd")
    if n_rows:
        launch_counts["layernorm_fwd"] += 1
    return out, res


def layernorm_bwd_cuda(r, g, gr, scale, *, eps: float, rms: bool):
    """Launch the backward's two kernels on the current stream: the row
    kernel (``dr`` and per-block partial sums), then the reduction of the
    partials. ``r``/``gr``: contiguous ``[N, D]`` in one dtype; ``g``:
    contiguous ``[N, D]`` float32 or bfloat16; ``scale``: float32 ``[D]``.
    Returns ``(dr, dscale f32, dbias f32)``."""
    from tpudist_torch.csrc import build

    _check("layernorm_bwd", [r, g, gr], [scale])
    if gr is not None and gr.dtype != r.dtype:
        raise ValueError("layernorm_bwd: r and its cotangent differ in dtype")
    n_rows, d = r.shape
    lib = build.load("layernorm.cu")
    if d > lib.tpudist_layernorm_max_d():
        raise ValueError(f"layernorm_bwd: D {d} above the kernel's "
                         f"{lib.tpudist_layernorm_max_d()}")
    parts = lib.tpudist_layernorm_bwd_parts(n_rows)
    dr = torch.empty_like(r)
    part = torch.empty((2, parts, d), dtype=torch.float64, device=r.device)
    sums = torch.empty((2, d), dtype=torch.float32, device=r.device)
    rc = lib.tpudist_layernorm_bwd(
        _CODE[r.dtype], _CODE[g.dtype], r.data_ptr(), g.data_ptr(), _ptr(gr),
        scale.data_ptr(), dr.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(), n_rows,
        d, parts, _inv_d(d), eps, int(rms),
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check(lib, rc, "layernorm_bwd")
    launch_counts["layernorm_bwd"] += 1
    launch_counts["layernorm_bwd_reduce"] += 1
    return dr, sums[0], sums[1]


def layernorm_fwd(x, y, scale, bias, **kw):
    """The forward kernel for CUDA tensors, its plain version for CPU
    tensors."""
    fn = layernorm_fwd_cuda if x.is_cuda else layernorm_fwd_plain
    return fn(x, y, scale, bias, **kw)


def layernorm_bwd(r, g, gr, scale, **kw):
    """The backward kernels for CUDA tensors, their plain version for CPU
    tensors."""
    fn = layernorm_bwd_cuda if r.is_cuda else layernorm_bwd_plain
    return fn(r, g, gr, scale, **kw)


def _cfg(ctx, scale, bias, eps, rms):
    ctx.eps, ctx.rms = eps, rms
    ctx.has_bias = bias is not None
    ctx.set_materialize_grads(False)


def _grads(ctx, r, g, gr, scale):
    if g is None:
        g = torch.zeros_like(r)
    dr, ds, db = layernorm_bwd(r, g.contiguous(),
                               None if gr is None else gr.contiguous(), scale,
                               eps=ctx.eps, rms=ctx.rms)
    return dr, ds.to(scale.dtype), db.to(scale.dtype) if ctx.has_bias else None


class _LNPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, rms, out_dtype):
        _cfg(ctx, scale, bias, eps, rms)
        n, _ = layernorm_fwd(x, None, scale, bias, eps=eps, rms=rms,
                             out_dtype=out_dtype, want_residual=False)
        ctx.save_for_backward(x, scale)
        return n

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, ds, db = _grads(ctx, x, g, None, scale)
        return dx, ds, db, None, None, None


class _LNPost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, scale, bias, eps, rms, out_dtype):
        _cfg(ctx, scale, bias, eps, rms)
        n, r = layernorm_fwd(x, y, scale, bias, eps=eps, rms=rms,
                             out_dtype=out_dtype, want_residual=True)
        ctx.save_for_backward(r, scale)
        return n

    @staticmethod
    def backward(ctx, g):
        r, scale = ctx.saved_tensors
        dr, ds, db = _grads(ctx, r, g, None, scale)
        return dr, dr, ds, db, None, None, None


class _LNPre(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, scale, bias, eps, rms, out_dtype):
        _cfg(ctx, scale, bias, eps, rms)
        n, r = layernorm_fwd(x, y, scale, bias, eps=eps, rms=rms,
                             out_dtype=out_dtype, want_residual=True)
        ctx.save_for_backward(r, scale)
        return n, r

    @staticmethod
    def backward(ctx, g, gr):
        r, scale = ctx.saved_tensors
        dr, ds, db = _grads(ctx, r, g, gr, scale)
        return dr, dr, ds, db, None, None, None


def fused_layernorm(x, scale, bias=None, *, residual=None, eps: float = 1e-6,
                    rms: bool = False, out_dtype=None,
                    return_residual: bool | None = None):
    """Fused (residual-add +) LayerNorm/RMSNorm over the last axis of ``x``
    (the reference's :func:`tpudist.ops.layernorm.fused_layernorm`).

    ``x``: ``[..., D]``; ``scale``/``bias``: ``[D]`` (``bias`` ignored
    under ``rms``), float32 or the compute copy's dtype (the kernel reads
    them in float32; their gradients come back in their own dtype).
    ``residual``: same shape as ``x``; the norm is of ``r = x + residual``.
    ``return_residual`` (default: ``residual is not None``) returns
    ``(n, r)``. ``out_dtype`` defaults to x's dtype."""
    if return_residual is None:
        return_residual = residual is not None
    if return_residual and residual is None:
        raise ValueError("return_residual=True needs a residual operand")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != x shape "
                         f"{tuple(x.shape)}")
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d).contiguous()
    s32 = scale.float()
    b32 = None if rms or bias is None else bias.float()
    if residual is None:
        return _LNPlain.apply(x2, s32, b32, eps, rms, out_dtype).reshape(
            *lead, d)
    y2 = residual.reshape(-1, d).contiguous().to(x.dtype)
    if return_residual:
        n, r = _LNPre.apply(x2, y2, s32, b32, eps, rms, out_dtype)
        return n.reshape(*lead, d), r.reshape(*lead, d)
    return _LNPost.apply(x2, y2, s32, b32, eps, rms, out_dtype).reshape(
        *lead, d)
