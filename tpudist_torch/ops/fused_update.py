"""One-pass fused AdamW for one parameter leaf.

Counterpart of :mod:`tpudist.ops.fused_update`. The kernel
(``tpudist_torch/csrc/fused_update.cu``) replaces the Pallas
``_update_kernel`` reached through ``fused_leaf_update``: it reads
``(grad, m, v, fp32 master)`` and writes ``(update, m', v')`` and,
optionally, the compute copy ``compute_dtype(p + u)`` in one sweep, so the
moments, the bias-corrected direction and the new parameter value it is
cast from never leave registers.

:func:`adamw_math` is the one formula, in optax's order (division-form
bias correction, ``sqrt(v_hat) + eps``, decay then scale). The plain
version runs it op by op in eager PyTorch, every op rounded once; the
kernel runs the same operations as explicitly rounded intrinsics, so the
two agree to the bit on the same inputs and the copy is bit-identical to
casting the post-update master.

What bounds the kernel on the H100: bytes, 28 per element with a bf16
gradient and a bf16 copy (g 2, m/v/p 12 read; u/m'/v' 12, copy 2
written) for about 15 f32 operations. Its design is a grid-stride loop
with 16-byte loads (module note in the ``.cu``); a multi-tensor launch
over all leaves and an in-place master update are later speed work.

:func:`fused_leaf_update` takes the kernel for CUDA tensors and the plain
version for CPU tensors; leaves under :data:`MIN_KERNEL_ELEMS` take the
plain formula on either, as the reference does (a launch per 64-element
bias is all overhead). The launch counter (:data:`launch_counts`) counts
kernel launches only.
"""

from __future__ import annotations

import torch

#: leaves below this many elements take the plain formula (the reference's
#: threshold, tpudist/ops/fused_update.py)
MIN_KERNEL_ELEMS = 8 * 128

#: launches of the kernel, counted where the wrapper launches it and
#: nowhere else (the plain version never counts)
launch_counts = {"fused_adamw": 0}

_G_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_COPY_CODE = {None: -1, torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def adamw_math(g, m, v, p, lr: float, b1c: float, b2c: float, *, b1: float,
               b2: float, eps: float, wd: float):
    """The AdamW formula both paths share, optax-order arithmetic:

    ``m' = b1*m + (1-b1)*g``; ``v' = b2*v + (1-b2)*g^2``;
    ``u = -lr * ((m'/b1c) / (sqrt(v'/b2c) + eps) + wd*p)``.

    ``lr``, ``b1c`` and ``b2c`` are this step's float32 scalars (python
    floats holding float32 values; ``b1c = 1 - b1**t``). Python-float
    constants round to float32 as the reference's weak-typed constants do.
    Returns ``(m', v', u)`` in float32.
    """
    g, m, v, p32 = g.float(), m.float(), v.float(), p.float()
    # PyTorch's CUDA kernels divide by a python scalar as a multiply by its
    # reciprocal, one rounding off; a 0-dim tensor on the device divides
    b1c, b2c = (torch.full((), c, dtype=torch.float32, device=m.device)
                for c in (b1c, b2c))
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * torch.square(g)
    mhat = m2 / b1c
    vhat = v2 / b2c
    direction = mhat / (torch.sqrt(vhat) + eps)
    if wd:
        direction = direction + wd * p32
    return m2, v2, direction * (-lr)


def fused_leaf_update_plain(g, m, v, p, lr, b1c, b2c, *, b1, b2, eps,
                            wd=0.0, compute_dtype=None):
    """The kernel's function in plain PyTorch (the small-leaf path, the
    CPU path, and the oracle the kernel is held to). Returns
    ``(u, m', v', copy|None)`` with ``u`` in ``p``'s dtype."""
    m2, v2, u = adamw_math(g, m, v, p, lr, b1c, b2c, b1=b1, b2=b2, eps=eps,
                           wd=wd)
    copy = None
    if compute_dtype is not None:
        copy = (p.float() + u).to(compute_dtype)
    return u.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype), copy


def _dense(t: torch.Tensor) -> bool:
    return t.is_contiguous() or (
        t.ndim == 4 and t.is_contiguous(memory_format=torch.channels_last))


def _same_layout(t: torch.Tensor, p: torch.Tensor) -> bool:
    """``t`` lays its elements out in memory as ``p`` does: the same
    shape and the same strides on every dim longer than 1 (a size-1 dim's
    stride is arbitrary: a 1x1 conv weight in channels-last and its
    contiguous gradient are one layout)."""
    return t.shape == p.shape and all(
        a == b for n, a, b in zip(p.shape, t.stride(), p.stride()) if n > 1)


def fused_leaf_update_cuda(g, m, v, p, lr, b1c, b2c, *, b1, b2, eps, wd=0.0,
                           compute_dtype=None, m_out=None, v_out=None,
                           copy_out=None):
    """Launch the kernel on the current stream. ``m``, ``v``, ``p`` are
    float32; ``g`` is float32, bfloat16 or float16; all share one shape
    and one dense layout (contiguous or channels-last), which the kernel
    walks as flat storage. ``m_out``/``v_out`` default to new tensors and
    may be ``m``/``v`` themselves (in place); ``copy_out`` (a tensor of
    ``compute_dtype``, e.g. the module's own parameter) receives the copy.
    Returns ``(u, m', v', copy|None)``."""
    from tpudist_torch.csrc import build

    if not p.is_cuda:
        raise ValueError("fused_adamw: p is not a CUDA tensor")
    if copy_out is not None:
        compute_dtype = copy_out.dtype
    if g.dtype not in _G_CODE:
        raise ValueError(f"fused_adamw: grad dtype {g.dtype} not in "
                         "(float32, bfloat16, float16)")
    if compute_dtype not in _COPY_CODE:
        raise ValueError(f"fused_adamw: compute dtype {compute_dtype} not in "
                         "(float32, bfloat16, float16)")
    if compute_dtype is not None and copy_out is None:
        copy_out = torch.empty_like(p, dtype=compute_dtype)
    m_out = torch.empty_like(m) if m_out is None else m_out
    v_out = torch.empty_like(v) if v_out is None else v_out
    u = torch.empty_like(p)
    tensors = [g, m, v, p, u, m_out, v_out] + (
        [copy_out] if copy_out is not None else [])
    for t in tensors[1:7]:
        if t.dtype != torch.float32:
            raise ValueError("fused_adamw: m, v, p and the outputs must be "
                             f"float32, got {t.dtype}")
    for t in tensors:
        if t.device != p.device:
            raise ValueError("fused_adamw: tensors on different devices")
        if not (_same_layout(t, p) and _dense(t)):
            raise ValueError(
                "fused_adamw: every tensor must have p's shape and one dense "
                f"layout; got {tuple(t.shape)} strides {t.stride()} against "
                f"{tuple(p.shape)} strides {p.stride()}")
    lib = build.load("fused_update.cu")
    rc = lib.tpudist_fused_adamw(
        _G_CODE[g.dtype], _COPY_CODE[compute_dtype], g.data_ptr(),
        m.data_ptr(), v.data_ptr(), p.data_ptr(), u.data_ptr(),
        m_out.data_ptr(), v_out.data_ptr(),
        copy_out.data_ptr() if copy_out is not None else None,
        p.numel(), b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, lr, b1c, b2c,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    build.check(lib, rc, "fused_adamw")
    launch_counts["fused_adamw"] += 1
    return u, m_out, v_out, copy_out


def fused_leaf_update(g, m, v, p, lr, b1c, b2c, *, b1, b2, eps, wd=0.0,
                      compute_dtype=None, m_out=None, v_out=None,
                      copy_out=None):
    """One leaf's AdamW: the kernel for a CUDA leaf of at least
    :data:`MIN_KERNEL_ELEMS` elements, the plain version otherwise.
    Returns ``(u, m', v', copy|None)``; the ``*_out`` tensors, when given,
    receive the results in place on either path (see
    :func:`fused_leaf_update_cuda`)."""
    if p.is_cuda and p.numel() >= MIN_KERNEL_ELEMS:
        return fused_leaf_update_cuda(
            g, m, v, p, lr, b1c, b2c, b1=b1, b2=b2, eps=eps, wd=wd,
            compute_dtype=compute_dtype, m_out=m_out, v_out=v_out,
            copy_out=copy_out)
    if copy_out is not None:
        compute_dtype = copy_out.dtype
    u, m2, v2, copy = fused_leaf_update_plain(
        g, m, v, p, lr, b1c, b2c, b1=b1, b2=b2, eps=eps, wd=wd,
        compute_dtype=compute_dtype)
    outs = []
    for new, out in ((m2, m_out), (v2, v_out), (copy, copy_out)):
        outs.append(new if out is None else out.copy_(new))
    return (u, *outs)
