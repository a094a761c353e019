"""Fused AdamW: one multi-tensor launch per optimizer step.

Counterpart of :mod:`tpudist.ops.fused_update`. The kernel
(``tpudist_torch/csrc/fused_update.cu``) replaces the Pallas
``_update_kernel`` reached through ``fused_leaf_update``: it reads
``(grad, m, v, fp32 master)`` and computes ``m'``, ``v'``, the update
``u`` and the compute copy ``compute_dtype(p + u)`` in one sweep, so the
moments, the bias-corrected direction and the new parameter value the copy
is cast from never leave registers.

:func:`adamw_math` is the one formula, in optax's order (division-form
bias correction, ``sqrt(v_hat) + eps``, decay then scale). The plain
version runs it op by op in eager PyTorch, every op rounded once; the
kernel runs the same operations as explicitly rounded intrinsics, so the
two agree to the bit on the same inputs and the copy is bit-identical to
casting the post-update master.

One kernel, two modes:

- :func:`fused_adamw_step` (optimizer mode, what :class:`FusedAdamW
  <tpudist_torch.optim.FusedAdamW>` runs): every leaf of a model, of any
  size, in one launch over an :class:`AdamWTable`; m and v in place, the
  master in place as ``p + u`` (the reference's ``optax.apply_updates``
  of the returned u, to the bit), the copy written, u never written: 28
  bytes an element with a bf16 gradient and copy.
- :func:`fused_leaf_update` (leaf mode, the JAX function's counterpart):
  one leaf, u, m', v' and the copy returned, p left alone; leaves under
  :data:`MIN_KERNEL_ELEMS` take the plain formula, as the reference's do.

What bounds the kernel on the H100: bytes, about 15 f32 operations for 28
bytes moved. The design (module note in the ``.cu``): the leaves are cut
into chunks of :data:`CHUNK_ELEMS` elements, a persistent grid takes the
chunks of all leaves in turn, 16-byte loads where a leaf's pointers allow.
The launch's table of leaves rides the kernel's parameter space, at most
:data:`MAX_TABLE_LEAVES` leaves a launch; :func:`plan_launches` groups the
leaves by dtype and splits a longer list into as few launches as fit.

The wrappers take the kernel for CUDA tensors and the plain version for
CPU tensors. :data:`launch_counts` counts kernel launches
(``fused_adamw``) and the leaves they covered (``fused_adamw_leaves``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

#: leaves below this many elements take the plain formula in
#: :func:`fused_leaf_update` (the reference's threshold,
#: tpudist/ops/fused_update.py); :func:`fused_adamw_step` takes every leaf
MIN_KERNEL_ELEMS = 8 * 128

#: elements of a chunk, the unit a block of the kernel takes (a multiple
#: of 4: the vector path walks four elements at a time)
CHUNK_ELEMS = 32768

#: leaves a launch's table holds (``kMaxLeaves`` in the ``.cu``, which the
#: wrapper checks against the built library)
MAX_TABLE_LEAVES = 480

#: launches of the kernel, counted where the wrapper launches it and
#: nowhere else (the plain version never counts), and the leaves they
#: covered
launch_counts = {"fused_adamw": 0, "fused_adamw_leaves": 0}

_G_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_COPY_CODE = {None: -1, torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: one leaf of a launch's table, as the kernel's ``Leaf`` lays it out
#: (``vec`` is set by the C side from the pointers)
LEAF_DTYPE = np.dtype([
    ("g", "<u8"), ("m", "<u8"), ("v", "<u8"), ("p", "<u8"), ("copy", "<u8"),
    ("n", "<i8"), ("wd", "<f4"), ("chunk0", "<i4"), ("vec", "<i4"),
    ("pad", "<i4")])
assert LEAF_DTYPE.itemsize == 64


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


def _check_leaf(t: torch.Tensor, p: torch.Tensor, what: str) -> None:
    if t.device != p.device:
        raise ValueError(f"fused_adamw: {what} on {t.device}, the master on "
                         f"{p.device}")
    if t.stride() != p.stride() and not _same_layout(t, p) or \
            t.shape != p.shape or not _dense(t):
        raise ValueError(
            f"fused_adamw: {what} must have the master's shape and one dense "
            f"layout; got {tuple(t.shape)} strides {t.stride()} against "
            f"{tuple(p.shape)} strides {p.stride()}")


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch of :func:`plan_launches`: the leaves' group key, their
    indices in the list, each one's first chunk and the chunk count."""

    key: tuple
    idx: tuple
    chunk0: tuple
    n_chunks: int


def plan_launches(keys, sizes, *, max_leaves: int = MAX_TABLE_LEAVES,
                  chunk: int = CHUNK_ELEMS) -> list[Launch]:
    """Cut a list of leaves into kernel launches: leaf ``i`` has group key
    ``keys[i]`` (its gradient and copy dtypes, which one launch shares) and
    ``sizes[i]`` elements. Groups come in the order of their first leaf,
    each leaf in list order, and a group longer than ``max_leaves`` takes
    as many launches as it needs. Leaf ``i`` of a launch has chunks
    ``chunk0[i] .. chunk0[i] + ceil(size / chunk) - 1`` of that launch,
    numbered without gaps; empty leaves need no launch and are left out."""
    groups: dict = {}
    for i, (key, n) in enumerate(zip(keys, sizes)):
        if n:
            groups.setdefault(key, []).append(i)
    out = []
    for key, idx in groups.items():
        for lo in range(0, len(idx), max_leaves):
            part = idx[lo:lo + max_leaves]
            counts = [math.ceil(sizes[i] / chunk) for i in part]
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            out.append(Launch(key, tuple(part), tuple(int(c) for c in starts),
                              int(sum(counts))))
    return out


class AdamWTable:
    """The static half of :func:`fused_adamw_step`'s launches over a fixed
    list of leaves: per leaf the float32 moments ``m`` and ``v``, the
    float32 master ``p``, the compute copy (a tensor, or None) and the
    decay coefficient ``wd``, all validated once here. Only the gradients
    change from step to step (they are new tensors each step); the launch
    records for each mix of gradient dtypes are built on first use and
    kept, so a step fills in the gradients' pointers and launches."""

    def __init__(self, m, v, p, copy, wd):
        self.m, self.v, self.p = list(m), list(v), list(p)
        self.copy, self.wd = list(copy), [float(w) for w in wd]
        if not (len(self.m) == len(self.v) == len(self.p) == len(self.copy)
                == len(self.wd)):
            raise ValueError("fused_adamw: m, v, p, copy and wd differ in "
                             "length")
        self._plans: dict = {}
        if not self.p or not self.p[0].is_cuda:
            return
        for m_, v_, p_, c in zip(self.m, self.v, self.p, self.copy):
            if p_.device != self.p[0].device:
                raise ValueError("fused_adamw: the masters lie on more than "
                                 "one device")
            for t, what in ((m_, "m"), (v_, "v"), (p_, "the master")):
                if t.dtype != torch.float32:
                    raise ValueError(f"fused_adamw: {what} must be float32, "
                                     f"got {t.dtype}")
                _check_leaf(t, p_, what)
            if c is not None:
                if c.dtype not in _G_CODE:
                    raise ValueError(f"fused_adamw: compute dtype {c.dtype} "
                                     "not in (float32, bfloat16, float16)")
                _check_leaf(c, p_, "the copy")
        self.records = np.zeros(len(self.p), LEAF_DTYPE)
        for name, ts in (("m", self.m), ("v", self.v), ("p", self.p),
                         ("copy", self.copy)):
            self.records[name] = [0 if t is None else t.data_ptr() for t in ts]
        self.records["n"] = [t.numel() for t in self.p]
        self.records["wd"] = self.wd
        self._copy_ptrs = list(self.records["copy"])

    def __len__(self) -> int:
        return len(self.p)

    def plan(self, g_dtypes) -> list[tuple]:
        """``[(g code, copy code, leaf indices, records, n_chunks)]``, one
        per launch, for gradients of ``g_dtypes`` (records with ``chunk0``
        filled, ``g`` left to the step)."""
        key = tuple(g_dtypes)
        plan = self._plans.get(key)
        if plan is None:
            keys = [(g, None if c is None else c.dtype)
                    for g, c in zip(key, self.copy)]
            plan = []
            for launch in plan_launches(keys, self.records["n"]):
                rec = self.records[list(launch.idx)].copy()
                rec["chunk0"] = launch.chunk0
                plan.append((_G_CODE[launch.key[0]],
                             _COPY_CODE[launch.key[1]], launch.idx, rec,
                             launch.n_chunks))
            self._plans[key] = plan
        return plan


def fused_adamw_step_plain(table: AdamWTable, grads, lr, b1c, b2c, *, b1,
                           b2, eps) -> None:
    """The optimizer-mode kernel's function in plain PyTorch: for each
    leaf, :func:`fused_leaf_update_plain`, then m, v and the copy written
    in place and ``p += u`` (the reference's ``optax.apply_updates``)."""
    for g, m, v, p, c, wd in zip(grads, table.m, table.v, table.p,
                                 table.copy, table.wd):
        u, m2, v2, cp = fused_leaf_update_plain(
            g, m, v, p, lr, b1c, b2c, b1=b1, b2=b2, eps=eps, wd=wd,
            compute_dtype=None if c is None else c.dtype)
        m.copy_(m2)
        v.copy_(v2)
        if c is not None:
            c.copy_(cp)
        p.add_(u)


def fused_adamw_step_cuda(table: AdamWTable, grads, lr, b1c, b2c, *, b1,
                          b2, eps) -> None:
    """Update every leaf of ``table`` in place from ``grads`` (one per
    leaf, float32, bfloat16 or float16, each in its master's layout) on the
    current stream: one kernel launch for each group of gradient and copy
    dtypes, more only past :data:`MAX_TABLE_LEAVES` leaves."""
    from tpudist_torch.csrc import build

    if not table.p or not table.p[0].is_cuda:
        raise ValueError("fused_adamw: the masters are not CUDA tensors")
    if len(grads) != len(table):
        raise ValueError(f"fused_adamw: {len(grads)} gradients for "
                         f"{len(table)} leaves")
    for g, p in zip(grads, table.p):
        if g.dtype not in _G_CODE:
            raise ValueError(f"fused_adamw: grad dtype {g.dtype} not in "
                             "(float32, bfloat16, float16)")
        _check_leaf(g, p, "a gradient")
    if [0 if c is None else c.data_ptr() for c in table.copy] != \
            table._copy_ptrs:
        raise ValueError("fused_adamw: a compute copy moved since the table "
                         "was built; build the optimizer state again")
    lib = build.load("fused_update.cu")
    if lib.tpudist_fused_adamw_max_leaves() != MAX_TABLE_LEAVES:
        raise RuntimeError("fused_adamw: the library's table size differs "
                           "from MAX_TABLE_LEAVES")
    stream = torch.cuda.current_stream(table.p[0].device).cuda_stream
    for g_code, c_code, idx, rec, n_chunks in table.plan(
            g.dtype for g in grads):
        rec["g"] = [grads[i].data_ptr() for i in idx]
        rc = lib.tpudist_fused_adamw_table(
            g_code, c_code, rec.ctypes.data, len(rec), n_chunks, CHUNK_ELEMS,
            b1, 1.0 - b1, b2, 1.0 - b2, eps, lr, b1c, b2c, None, None, None,
            stream)
        build.check(lib, rc, "fused_adamw")
        launch_counts["fused_adamw"] += 1
        launch_counts["fused_adamw_leaves"] += len(rec)


def fused_adamw_step(table: AdamWTable, grads, lr, b1c, b2c, *, b1, b2,
                     eps) -> None:
    """One optimizer step over every leaf of ``table``: the kernel for CUDA
    leaves, the plain version for CPU leaves."""
    if not len(table):
        return
    fn = fused_adamw_step_cuda if table.p[0].is_cuda else \
        fused_adamw_step_plain
    fn(table, grads, lr, b1c, b2c, b1=b1, b2=b2, eps=eps)


def fused_leaf_update_cuda(g, m, v, p, lr, b1c, b2c, *, b1, b2, eps, wd=0.0,
                           compute_dtype=None, m_out=None, v_out=None,
                           copy_out=None):
    """The kernel in leaf mode on the current stream: a one-leaf table.
    ``m``, ``v``, ``p`` are float32; ``g`` is float32, bfloat16 or
    float16; all share one shape and one dense layout (contiguous or
    channels-last), which the kernel walks as flat storage. ``m_out``/
    ``v_out`` default to new tensors and may be ``m``/``v`` themselves (in
    place); ``copy_out`` (a tensor of ``compute_dtype``) receives the copy.
    ``p`` is left as it was. Returns ``(u, m', v', copy|None)``."""
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
    for t, what in ((m, "m"), (v, "v"), (p, "p"), (u, "u"), (m_out, "m_out"),
                    (v_out, "v_out")):
        if t.dtype != torch.float32:
            raise ValueError("fused_adamw: m, v, p and the outputs must be "
                             f"float32, got {t.dtype} for {what}")
    for t, what in ((g, "g"), (m, "m"), (v, "v"), (p, "p"), (u, "u"),
                    (m_out, "m_out"), (v_out, "v_out"), (copy_out, "copy")):
        if t is not None:
            _check_leaf(t, p, what)
    n = p.numel()
    if n == 0:
        return u, m_out, v_out, copy_out
    rec = np.zeros(1, LEAF_DTYPE)
    rec[0] = (g.data_ptr(), m.data_ptr(), v.data_ptr(), p.data_ptr(),
              0 if copy_out is None else copy_out.data_ptr(), n, wd, 0, 0, 0)
    lib = build.load("fused_update.cu")
    rc = lib.tpudist_fused_adamw_table(
        _G_CODE[g.dtype], _COPY_CODE[compute_dtype], rec.ctypes.data, 1,
        math.ceil(n / CHUNK_ELEMS), CHUNK_ELEMS, b1, 1.0 - b1, b2, 1.0 - b2,
        eps, lr, b1c, b2c, u.data_ptr(), m_out.data_ptr(), v_out.data_ptr(),
        torch.cuda.current_stream(p.device).cuda_stream)
    build.check(lib, rc, "fused_adamw")
    launch_counts["fused_adamw"] += 1
    launch_counts["fused_adamw_leaves"] += 1
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
