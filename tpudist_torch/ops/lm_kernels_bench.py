"""Parity and device times of the GPT-2 training kernels on the card.

    python -m tpudist_torch.ops.lm_kernels_bench            # parity, then times
    python -m tpudist_torch.ops.lm_kernels_bench --parity   # parity only
    python -m tpudist_torch.ops.lm_kernels_bench --train_ab # end to end, in turns
    python -m tpudist_torch.ops.lm_kernels_bench --train_ab --seq_len 4096
    python -m tpudist_torch.ops.lm_kernels_bench --decode_ab # serving copy, in turns
    python -m tpudist_torch.ops.lm_kernels_bench --ab DIR   # DIR's LN/attention kernels vs this
    python -m tpudist_torch.ops.lm_kernels_bench --order    # bf16 attention vs sum orders
    python -m tpudist_torch.ops.lm_kernels_bench --head     # tied head products, in turns

The kernels are the fused residual-add + LayerNorm forward and backward
(:mod:`tpudist_torch.ops.layernorm`), the whole-row attention forward
and backward (:mod:`tpudist_torch.ops.vmem_attention`) and the blockwise
flash attention forward and backward
(:mod:`tpudist_torch.ops.flash_attention`).

Parity holds each kernel against its plain PyTorch version on the same
inputs on the card, under the repo's kernel-parity rule (2e-5 absolute
plus relative in float32, 2% of the plain result's largest magnitude in
bfloat16) and, for bfloat16 outputs, element by element as well: within
:data:`ELEM_ULPS` bf16 ulps of the plain value plus :data:`ELEM_ATOL` of
its largest magnitude. Cases: LayerNorm at GPT-2's 8192 x 768 rows, a
ragged 1000 x 200, 1000 x 197 (a width that is no multiple of 16 bytes:
the forward's element-wise path) and 1000 x 768 rows that start one
element into their buffers (misaligned: the element-wise path again), the
three compositions, RMS on and off; attention at
GPT-2's B 8, H 12, S 1024, D 64 causal (q, k, v strided views of one qkv
tensor, as the model passes them), S 197 non-causal, ``kv_len`` < S, GQA
with 4 K/V heads, and head dims 32, 80, 128 and 20; flash attention at the
long-context leg's B 4, H 12, S 4096, D 64 causal (strided views again),
S 2048 non-causal, a ragged S 2100, ``kv_len`` 1900 < S 2048 causal and
not, GQA H 12 / H_kv 4 repeated as ``multi_head_attention`` repeats it,
and head dims 128, 80, 32 and 20; float32 and bfloat16 throughout. At
D 20 the head stride is 20 elements, so the bf16 backward loads its tiles
element by element instead of by 16-byte copies. Before the parity lines
each attention source's kernels are listed with their registers and
spills from the build's ``-Xptxas -v`` report, forwards and backward.

Times are at the training path's shapes in bfloat16: the median device
time of 50 calls between CUDA events, the card held busy while the host
enqueues and the L2 flushed before each call
(:func:`tpudist_torch.ops.decode_bench.device_ms`), beside the call's
bound and one PyTorch library call computing the same function
(``F.layer_norm``, ``aten.native_layer_norm_backward``,
``scaled_dot_product_attention`` and its backward through autograd), a
yardstick the port never calls. A bound is the larger of the bytes the
call must move (each input read once, each output written once) over
3.35 TB/s and its operations over the peak rate of their type (bf16
products 989 TFLOP/s on the tensor cores, float32 arithmetic 67 TFLOP/s;
NVIDIA's H100 SXM data sheet, dense), counting only the causal half of
the score matrix that the data needs.

``--train_ab`` trains GPT-2 124M (bf16, 16 steps, one process, no
profiler) on two paths in turns (A, B, B, A), and prints each run's step
time at g_step 15 (the TSV), its tokens/s over the run and its peak
device memory. At S 1024 (batch 8) the paths are the kernels' path
(``--fused all --attn auto``) and the dense path (``--fused optimizer
--attn xla``: dense attention and the unfused LayerNorm, the fused AdamW
kept). From S 2048 (``--seq_len``, batch 4) they are the reference's
long-context leg (``bench.py``'s flash-versus-XLA step): ``--attn flash
--chunked_ce 256`` against ``--attn xla --chunked_ce 256``, both under
``--fused all``, so only the attention differs; a run that exhausts the
card's memory is reported as such. Both train on :func:`token_file`'s
fixed text.

``--ab DIR`` times kernels built from another revision's sources against
this checkout's, in turns (A, B, B, A) on the same inputs, for each source
DIR holds: ``layernorm.cu``, the plain and pre-norm forwards at 8192 x
768 bf16 (row 5 of PERF.md's kernel table); ``flash_attention.cu`` and
``vmem_attention.cu`` (with the headers they include), the bf16 forward
and backward (the delta, dk/dv and dq kernels of one call) at rows 7-8
and 3-4: flash at B 4, H 12, S 4096, D 64 causal and vmem at B 8, H 12,
S 1024, D 64 causal. For the parent commit, e.g.::

    mkdir -p scratch_chip/parent
    for f in layernorm.cu flash_attention.cu vmem_attention.cu \
        attention_tiles.cuh attention_mma.cuh; do
      git show HEAD~1:tpudist_torch/csrc/$f > scratch_chip/parent/$f; done

It prints each turn's median device time (as the times above), the ratio
of the two sides' sums, each side's parity error, and the card's name and
power limit.

``--order`` shows why the plain versions sum s (and the vmem backward
dp) as the kernels do: at every vmem and flash case in bf16 it holds the
outputs that round p (both forwards' o, the vmem backward's dq, dk, dv)
against the plain version with those products summed on the tensor
cores, as f32 FMAs and in f64 (:data:`ORDER_DOTS`), and the f32 sums
against the f64 ones, each line with its element-wise reading.

``--head`` times the weight-tied LM head's three products at GPT-2's
S 1024 step (bf16 operands, f32 sums) at V 50257 and at 50304, whose
operand rows are all 16-byte aligned, in turns, naming the kernels cuBLAS
runs; then its bf16 backward with the cotangent rounded to one bf16 and
carried as hi + lo, in turns.

``--decode_ab`` times the decode step of GPT-2 124M in bf16 (B 8, a
64-token prompt, ``attn_impl="fused"``) on the float32-master model,
which casts every weight at every use, and on the serving engine's
:func:`tpudist_torch.models.gpt2.compute_copy`, in turns (copy, masters,
masters, copy): wall time per step over 32 steps, the card synchronised
at the ends only, as the engine runs them.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from tpudist_torch.ops import decode_bench as DB
from tpudist_torch.ops import flash_attention as FA
from tpudist_torch.ops import layernorm as LN
from tpudist_torch.ops import vmem_attention as VA

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: about 10 ms at the H100's clock: longer than enqueueing a plain version
SPIN_CYCLES = 20_000_000
EPS = 1e-5
B, H, S, D = 8, 12, 1024, 64
ROWS, WIDTH = B * S, H * D
#: the long-context leg's attention: B 4 sequences of S 4096
FB, FS = 4, 4096


#: the element-wise bar of a bfloat16 output: ``|got - want| <= ELEM_ULPS
#: * ulp(want) + ELEM_ATOL * max|want|``, ulp being the spacing of bf16
#: numbers at ``|want|``. Set from the kernels' readings on the H100
#: (PERF.md): every bf16 output within one ulp plus at most 1.85e-5 of
#: its largest magnitude (the D 128 dq), so twice the ulp and about three
#: times that absolute term
ELEM_ULPS = 2.0
ELEM_ATOL = 2.0 ** -14


def parity_tol(want):
    """The repo's kernel-parity rule (tests/conftest.py)."""
    if want.dtype == torch.float32:
        return 2e-5, 2e-5
    return 2e-2 * float(want.float().abs().max().clamp_min(1e-6)), 0.0


def bf16_ulp(w):
    """The spacing of bfloat16 numbers at ``|w|`` (float32 ``w``)."""
    _, e = torch.frexp(w.abs().clamp_min(torch.finfo(torch.bfloat16).tiny))
    return torch.ldexp(torch.ones_like(w), e - 8)


def max_err(got, want, *, elem: bool = True) -> tuple[float, bool]:
    """``(max abs error, within the parity rule, finite, and with
    ``elem`` for a bf16 ``want`` within the element-wise bar)``."""
    atol, rtol = parity_tol(want)
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ok = bool((d <= atol + rtol * w.abs()).all()) and bool(
        torch.isfinite(g).all())
    if elem and want.dtype == torch.bfloat16:
        bar = ELEM_ULPS * bf16_ulp(w) + ELEM_ATOL * float(w.abs().max())
        ok = ok and bool((d <= bar).all())
    return float(d.max()), ok


def elem_reading(got, want) -> str:
    """For a bf16 output: the largest error in bf16 ulps of the plain
    value (over the elements above ``ELEM_ATOL`` of the largest), and the
    ``ELEM_ATOL`` it would need beside a one-ulp allowance (the readings
    the element-wise bar was set from)."""
    g, w = got.float(), want.float()
    d, ulp = (g - w).abs(), bf16_ulp(w)
    top = float(w.abs().max().clamp_min(1e-30))
    big = w.abs() > ELEM_ATOL * top
    ulps = float((d / ulp)[big].max()) if bool(big.any()) else 0.0
    need = float((d - ulp).clamp_min(0).max()) / top
    return f"{ulps:.2f} ulps, atol beyond 1 ulp {need:.2e}"


def _rand(gen, shape, dtype, scale=1.0, shift=0.0):
    t = torch.randn(shape, generator=gen, device="cuda") * scale + shift
    return t.to(dtype)


def ln_inputs(gen, n, d, dtype, offset: int = 0):
    """x, y, scale, bias, g, gr for ``n`` rows of width ``d``; with
    ``offset`` x and y are contiguous rows that start ``offset`` elements
    into a flat buffer."""
    def rows():
        return _rand(gen, (n * d + offset,), dtype)[offset:].view(n, d)

    return dict(x=rows(), y=rows(),
                scale=_rand(gen, (d,), torch.float32, 0.1, 1.0),
                bias=_rand(gen, (d,), torch.float32, 0.1),
                g=_rand(gen, (n, d), dtype), gr=_rand(gen, (n, d), dtype))


#: LayerNorm parity cases, (rows, width, offset of x and y in elements)
LN_CASES = ((ROWS, WIDTH, 0), (1000, 200, 0), (1000, 197, 0), (1000, WIDTH, 1))


def ln_parity(gen):
    """Yield ``(name, got, want)`` for every LayerNorm parity case."""
    for n, d, off in LN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            t = ln_inputs(gen, n, d, dtype, off)
            for comp in ("plain", "pre", "post"):
                for rms in (False, True):
                    y = None if comp == "plain" else t["y"]
                    gr = t["gr"] if comp == "pre" else None
                    bias = None if rms else t["bias"]
                    kw = dict(eps=EPS, rms=rms, out_dtype=dtype,
                              want_residual=comp != "plain")
                    kn, kr = LN.layernorm_fwd_cuda(t["x"], y, t["scale"],
                                                   bias, **kw)
                    pn, pr = LN.layernorm_fwd_plain(t["x"], y, t["scale"],
                                                    bias, **kw)
                    r = t["x"] if comp == "plain" else pr
                    bk = LN.layernorm_bwd_cuda(r, t["g"], gr, t["scale"],
                                               eps=EPS, rms=rms)
                    bp = LN.layernorm_bwd_plain(r, t["g"], gr, t["scale"],
                                                eps=EPS, rms=rms)
                    tag = (f"ln {n}x{d}{f' at +{off}' if off else ''} "
                           f"{str(dtype)[6:]} {comp}"
                           f"{' rms' if rms else ''}")
                    yield f"{tag} n", kn, pn
                    if kr is not None:
                        yield f"{tag} r", kr, pr
                    yield f"{tag} dx=dy", bk[0], bp[0]
                    yield f"{tag} dscale", bk[1], bp[1]
                    if not rms:
                        yield f"{tag} dbias", bk[2], bp[2]


def attn_inputs(gen, b, s, h, h_kv, dtype, *, strided=False, d=D):
    """q [b, s, h, d] and k, v [b, s, h_kv, d] (with ``strided``: views of
    one [b, s, 3, h, d] tensor, as GPT-2's qkv split gives them), and do."""
    if strided:
        qkv = _rand(gen, (b, s, 3, h, d), dtype)
        q, k, v = qkv.unbind(2)
    else:
        q = _rand(gen, (b, s, h, d), dtype)
        k, v = (_rand(gen, (b, s, h_kv, d), dtype) for _ in range(2))
    return q, k, v, _rand(gen, (b, s, h, d), dtype)


#: (tag, b, s, h, h_kv, causal, kv_len, strided, head dim)
ATTN_CASES = (
    ("main path", B, S, H, H, True, None, True, D),
    ("S 197 non-causal", 4, 197, H, H, False, None, False, D),
    ("kv_len 200 < S 256 causal", B, 256, H, H, True, 200, False, D),
    ("kv_len 150 < S 256 non-causal", B, 256, H, H, False, 150, False, D),
    ("GQA H 12 / H_kv 4 causal", B, S, H, 4, True, None, False, D),
    ("D 128 causal", 4, 512, 8, 8, True, None, True, 128),
    ("D 80 GQA H 8 / H_kv 2 kv_len 300", 2, 384, 8, 2, False, 300, False, 80),
    ("D 32 S 197 causal", 4, 197, 8, 8, True, None, True, 32),
    ("D 20 GQA H 4 / H_kv 2 kv_len 200 < S 256 causal", 2, 256, 4, 2, True,
     200, False, 20),
)


def attn_parity(gen):
    """Yield ``(name, got, want)`` for every attention parity case: the
    forward's o and lse, then the backward's dq, dk, dv from the kernel's
    own (o, lse)."""
    for tag, b, s, h, h_kv, causal, kv_len, strided, d in ATTN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = attn_inputs(gen, b, s, h, h_kv, dtype,
                                      strided=strided, d=d)
            kw = dict(causal=causal, kv_len=kv_len or s,
                      scale=VA._scale(d))
            ko, kl = VA.vmem_fwd_cuda(q, k, v, **kw)
            po, pl = VA.vmem_fwd_plain(q, k, v, **kw)
            name = f"vmem {tag} {str(dtype)[6:]}"
            yield f"{name} o", ko, po
            yield f"{name} lse", kl, pl
            kg = VA.vmem_bwd_cuda(q, k, v, ko, do, kl, **kw)
            pg = VA.vmem_bwd_plain(q, k, v, ko, do, kl, **kw)
            for gname, got, want in zip(("dq", "dk", "dv"), kg, pg):
                yield f"{name} {gname}", got, want
            del po, pl, pg


#: (tag, b, s, h, h_kv, causal, kv_len, strided, head dim); grouped K/V
#: heads are repeated before the kernels, as multi_head_attention does
FLASH_CASES = (
    ("main path", FB, FS, H, H, True, None, True, D),
    ("S 2048 non-causal", 2, 2048, H, H, False, None, False, D),
    ("ragged S 2100 causal", 2, 2100, H, H, True, None, False, D),
    ("kv_len 1900 < S 2048 causal", 2, 2048, H, H, True, 1900, False, D),
    ("kv_len 1900 < S 2048 non-causal", 2, 2048, H, H, False, 1900, False, D),
    ("GQA H 12 / H_kv 4 repeated, causal", 2, 2048, H, 4, True, None, False, D),
    ("D 128 causal", 2, 2048, 8, 8, True, None, True, 128),
    ("D 80 S 2100 kv_len 2000 non-causal", 2, 2100, 8, 8, False, 2000, False, 80),
    ("D 32 causal", 2, 2048, 8, 8, True, None, True, 32),
    ("D 20 ragged S 2100 causal", 1, 2100, 4, 4, True, None, True, 20),
)


def flash_parity(gen):
    """Yield ``(name, got, want)`` for every flash parity case: the
    forward's o and lse, then the backward's dq, dk, dv from the kernel's
    own (o, lse)."""
    from tpudist_torch.ops.attention import repeat_kv

    for tag, b, s, h, h_kv, causal, kv_len, strided, d in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = attn_inputs(gen, b, s, h, h_kv, dtype,
                                      strided=strided, d=d)
            k, v = repeat_kv(q, k, v)
            kw = dict(causal=causal, kv_len=kv_len or s, scale=VA._scale(d))
            ko, kl = FA.flash_fwd_cuda(q, k, v, **kw)
            po, pl = FA.flash_fwd_plain(q, k, v, **kw)
            name = f"flash {tag} {str(dtype)[6:]}"
            yield f"{name} o", ko, po
            yield f"{name} lse", kl, pl
            del po, pl
            kg = FA.flash_bwd_cuda(q, k, v, ko, do, kl, **kw)
            pg = FA.flash_bwd_plain(q, k, v, ko, do, kl, **kw)
            for gname, got, want in zip(("dq", "dk", "dv"), kg, pg):
                yield f"{name} {gname}", got, want
            del kg, pg


def attention_build(source: str) -> tuple[list[str], list[str]]:
    """The attention kernels' lines of ``source``'s ``-Xptxas -v`` report
    (registers, spill stores and loads, stack), forwards and backward, and
    the names of the bf16 HD 64 tensor-core instantiations among them that
    spill (there must be none)."""
    import re

    from tpudist_torch.csrc import build

    lines, spilled = [], []
    for r in build.register_report(source):
        if not any(n in r["kernel"] for n in ("fwd", "delta", "dkdv", "dq")):
            continue
        lines.append(f"{r['kernel']}: {r['registers']} registers, "
                     f"{r['spill_stores']} / {r['spill_loads']} bytes spill "
                     f"stores / loads, {r['stack']} bytes stack")
        if "_mma_" in r["kernel"] and re.search(r"<64[,>]", r["kernel"]) and (
                r["spill_stores"] or r["spill_loads"]):
            spilled.append(r["kernel"])
    return lines, spilled


def ln_build() -> tuple[list[str], list[str]]:
    """The LayerNorm kernels' lines of ``layernorm.cu``'s ``-Xptxas -v``
    report and the names of the bf16 forward instantiations for widths up
    to 768 (``PER`` 24, GPT-2's) among them that spill (there must be
    none)."""
    from tpudist_torch.csrc import build

    lines, spilled = [], []
    for r in build.register_report("layernorm.cu"):
        lines.append(f"{r['kernel']}: {r['registers']} registers, "
                     f"{r['spill_stores']} / {r['spill_loads']} bytes spill "
                     f"stores / loads, {r['stack']} bytes stack")
        if (r["kernel"].startswith("ln_fwd_kernel<") and "bf16" in r["kernel"]
                and r["kernel"].endswith(", 24>")
                and (r["spill_stores"] or r["spill_loads"])):
            spilled.append(r["kernel"])
    return lines, spilled


def ln_repeat_identical(gen) -> dict:
    """Whether two forward calls at 8192 x 768 bf16 give bit-identical
    outputs, plain (``n``) and pre-norm (``n``, ``r``)."""
    t = ln_inputs(gen, ROWS, WIDTH, torch.bfloat16)
    out = {}
    for name, y in (("plain", None), ("pre-norm", t["y"])):
        kw = dict(eps=EPS, rms=False, out_dtype=torch.bfloat16,
                  want_residual=y is not None)
        a = LN.layernorm_fwd_cuda(t["x"], y, t["scale"], t["bias"], **kw)
        b = LN.layernorm_fwd_cuda(t["x"], y, t["scale"], t["bias"], **kw)
        out[name] = all(torch.equal(p, q) for p, q in zip(a, b)
                        if p is not None)
    return out


def repeat_identical(kind: str, gen, b, s) -> dict:
    """Whether two calls of ``kind``'s (``"vmem"`` or ``"flash"``) forward
    give bit-identical o and lse, and two of its backward bit-identical
    dq, dk and dv, on the same bf16 inputs (H 12, D 64, causal, strided
    views of one qkv tensor): ``{"forward": bool, "backward": bool}``."""
    mod = FA if kind == "flash" else VA
    fwd = getattr(mod, f"{kind}_fwd_cuda")
    bwd = getattr(mod, f"{kind}_bwd_cuda")
    q, k, v, do = attn_inputs(gen, b, s, H, H, torch.bfloat16, strided=True)
    kw = dict(causal=True, kv_len=s, scale=VA._scale(D))
    same = lambda x, y: all(torch.equal(a, b) for a, b in zip(x, y))
    first = fwd(q, k, v, **kw)
    out = {"forward": same(first, fwd(q, k, v, **kw))}
    o, lse = first
    out["backward"] = same(bwd(q, k, v, o, do, lse, **kw),
                           bwd(q, k, v, o, do, lse, **kw))
    return out


def bound(nbytes: int, flops: float, dtype) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def timing_cases(gen) -> list[dict]:
    """The four kernels at the training path's shapes in bf16, each with
    ``kernel``/``plain``/``library`` callables, the parity error of the
    timed inputs and its bound. LayerNorm: the plain composition (``ln_1``
    and ``ln_f``; F.layer_norm computes the same function) and, as
    ``*_prenorm`` extras, the pre-norm one (``ln_2``)."""
    dt = torch.bfloat16
    t = ln_inputs(gen, ROWS, WIDTH, dt)
    x, y, scale, bias, g, gr = (t[k] for k in ("x", "y", "scale", "bias", "g",
                                               "gr"))
    elems, item = ROWS * WIDTH, x.element_size()
    fkw = dict(eps=EPS, rms=False, out_dtype=dt)
    cases = []

    def ln_case(name, kernel, plain, library, nbytes, flops_per_elem):
        got, want = kernel(), plain()
        err = max(max_err(a, b)[0] for a, b in zip(got, want)
                  if a is not None)
        cases.append(dict(name=name, kernel=kernel, plain=plain,
                          library=library, max_abs_err=err,
                          shape=f"{ROWS} x {WIDTH} rows, bf16",
                          **bound(nbytes, flops_per_elem * elems,
                                  torch.float32)))

    sb, bb = scale.to(dt), bias.to(dt)
    ln_case("layernorm_fwd",
            lambda: LN.layernorm_fwd_cuda(x, None, scale, bias,
                                          want_residual=False, **fkw),
            lambda: LN.layernorm_fwd_plain(x, None, scale, bias,
                                           want_residual=False, **fkw),
            lambda: F.layer_norm(x, (WIDTH,), sb, bb, EPS),
            2 * elems * item + 2 * WIDTH * 4, 9)
    ln_case("layernorm_fwd_prenorm",
            lambda: LN.layernorm_fwd_cuda(x, y, scale, bias,
                                          want_residual=True, **fkw),
            lambda: LN.layernorm_fwd_plain(x, y, scale, bias,
                                           want_residual=True, **fkw),
            None, 4 * elems * item + 2 * WIDTH * 4, 10)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, (WIDTH,), sb, bb, EPS)
    ln_case("layernorm_bwd",
            lambda: LN.layernorm_bwd_cuda(x, g, None, scale, eps=EPS,
                                          rms=False),
            lambda: LN.layernorm_bwd_plain(x, g, None, scale, eps=EPS,
                                           rms=False),
            lambda: torch.ops.aten.native_layer_norm_backward(
                g, x, (WIDTH,), mean, rstd, sb, bb, [True, True, True]),
            3 * elems * item + 3 * WIDTH * 4, 16)
    ln_case("layernorm_bwd_prenorm",
            lambda: LN.layernorm_bwd_cuda(x, g, gr, scale, eps=EPS,
                                          rms=False),
            lambda: LN.layernorm_bwd_plain(x, g, gr, scale, eps=EPS,
                                           rms=False),
            None, 4 * elems * item + 3 * WIDTH * 4, 17)

    cases += attention_cases(
        "vmem_attention", VA.vmem_fwd_cuda, VA.vmem_fwd_plain,
        VA.vmem_bwd_cuda, VA.vmem_bwd_plain, gen, B, S,
        f"B {B}, H {H}, S {S}, D {D}, causal, bf16")
    return cases


def attention_cases(prefix, fwd_cuda, fwd_plain, bwd_cuda, bwd_plain,
                    gen, b, s, shape) -> list[dict]:
    """The forward and backward of one attention kernel pair at ``b``
    sequences of ``s`` (H 12, D 64, causal, bf16, q/k/v strided views of
    one qkv tensor) with their plain versions, parity errors, bounds and
    ``scaled_dot_product_attention`` (forward, and backward through
    autograd) as the library call."""
    dt = torch.bfloat16
    q, k, v, do = attn_inputs(gen, b, s, H, H, dt, strided=True)
    akw = dict(causal=True, kv_len=s, scale=VA._scale(D))
    qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
    tensor = b * s * H * D * q.element_size()
    lse_bytes = b * H * s * 4
    # causal: the score entries the mask keeps, s (s + 1) / 2 per head
    kept = b * H * s * (s + 1) / 2
    got, want = fwd_cuda(q, k, v, **akw), fwd_plain(q, k, v, **akw)
    o, lse = got
    cases = [dict(
        name=f"{prefix}_fwd",
        kernel=lambda: fwd_cuda(q, k, v, **akw),
        plain=lambda: fwd_plain(q, k, v, **akw),
        library=lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                       is_causal=True),
        max_abs_err=max(max_err(a, w)[0] for a, w in zip(got, want)),
        shape=shape, **bound(4 * tensor + lse_bytes, 2 * 2 * D * kept, dt))]
    del want
    ql, kl, vl = (a.detach().clone().requires_grad_() for a in (qh, kh, vh))
    lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    doh = do.transpose(1, 2)
    got = bwd_cuda(q, k, v, o, do, lse, **akw)
    want = bwd_plain(q, k, v, o, do, lse, **akw)
    cases.append(dict(
        name=f"{prefix}_bwd",
        kernel=lambda: bwd_cuda(q, k, v, o, do, lse, **akw),
        plain=lambda: bwd_plain(q, k, v, o, do, lse, **akw),
        library=lambda: torch.autograd.grad(lo, (ql, kl, vl), doh,
                                            retain_graph=True),
        max_abs_err=max(max_err(a, w)[0] for a, w in zip(got, want)),
        shape=shape, **bound(8 * tensor + lse_bytes, 5 * 2 * D * kept, dt)))
    return cases


def flash_timing_cases(gen) -> list[dict]:
    """The flash kernels at the long-context leg's shape (B 4, H 12,
    S 4096, D 64, causal, bf16), as :func:`attention_cases`."""
    return attention_cases(
        "flash_attention", FA.flash_fwd_cuda, FA.flash_fwd_plain,
        FA.flash_bwd_cuda, FA.flash_bwd_plain, gen, FB, FS,
        f"B {FB}, H {H}, S {FS}, D {D}, causal, bf16")


def time_case(case, flush) -> dict:
    """Device ms of the kernel, the plain version and the library call."""
    out = {}
    for key in ("kernel", "plain", "library"):
        fn = case[key]
        out[f"{key}_ms"] = (None if fn is None else
                            DB.device_ms(fn, flush, spin_cycles=SPIN_CYCLES))
    return out


#: the text :func:`token_file` trains on: documents of the JAX reference
#: that the port never edits, so every run of every revision reads the
#: same bytes (142,148 of them, more than the 131,072 of a 16-step run)
TEXT_FILES = ("SURVEY.md", "docs/LM_TRAINING.md", "docs/MULTIHOST.md",
              "docs/OBSERVABILITY.md", "docs/SERVING.md")


def token_file(path: Path, n_tokens: int) -> Path:
    """``n_tokens`` byte tokens of :data:`TEXT_FILES` (repeated if
    short), as a uint16 ``.bin``: text a model can learn from, made
    without a download."""
    from tpudist_torch.data.lm import encode_bytes

    root = Path(__file__).resolve().parents[2]
    text = b"".join((root / n).read_bytes() for n in TEXT_FILES)
    np.resize(encode_bytes(text), n_tokens).astype(np.uint16).tofile(path)
    return path


#: --train_ab's two paths at S 1024: (name, train_gpt2 flags)
AB_PATHS = (("kernels", ["--fused", "all", "--attn", "auto"]),
            ("dense", ["--fused", "optimizer", "--attn", "xla"]))
#: and from S 2048: the reference's long-context leg, flash against the
#: dense attention on the same chunked-CE step
AB_PATHS_LONG = (
    ("flash", ["--fused", "all", "--attn", "flash", "--chunked_ce", "256"]),
    ("dense", ["--fused", "all", "--attn", "xla", "--chunked_ce", "256"]))


def train_ab(seq_len: int = 1024, steps: int = 16) -> list[dict]:
    """The two paths for ``seq_len`` (module docstring) in turns (A, B, B,
    A). A run that exhausts the card's memory reports ``oom`` instead of
    its numbers."""
    from tpudist_torch import train_gpt2

    paths, batch = (AB_PATHS, 8) if seq_len <= 1024 else (AB_PATHS_LONG, 4)
    out = []
    with tempfile.TemporaryDirectory() as log_dir:
        tokens = token_file(Path(log_dir) / "text.bin",
                            steps * batch * seq_len)
        for n, i in enumerate((0, 1, 1, 0)):
            name, flags = paths[i]
            torch.cuda.reset_peak_memory_stats()
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    _, losses = train_gpt2.main([
                        *flags, "--bf16", "--batch_size", str(batch),
                        "--seq_len", str(seq_len), "--tokens", str(tokens),
                        "--no_profiler", "--JobID", f"AB{n}",
                        "--log_dir", log_dir])
            except torch.cuda.OutOfMemoryError as e:
                out.append(dict(path=name, oom=str(e).splitlines()[0],
                                peak_gib=torch.cuda.max_memory_allocated()
                                / 2**30))
                torch.cuda.empty_cache()
                continue
            rows = (Path(log_dir) / f"AB{n}_{batch}_0.log").read_text() \
                .splitlines()
            eps15 = float(rows[3].split("\t")[4])
            train_s = float(rows[-1].split("\t")[1])
            out.append(dict(
                path=name, step_ms=batch / eps15 * 1e3,
                tokens_per_s=len(losses) * batch * seq_len / train_s,
                final_loss=losses[-1],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30))
    return out


def decode_ab(steps: int = 32) -> list[dict]:
    """Decode-step wall time on the float32 masters and on the serving
    copy, in turns (copy, masters, masters, copy)."""
    from tpudist_torch.generate import reset_cursors, zero_cache
    from tpudist_torch.models.gpt2 import GPT2, compute_copy

    master = GPT2(dtype=torch.bfloat16, attn_impl="fused", device="cuda")
    models = {"copy": compute_copy(master), "masters": master}
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, master.vocab_size, (8, 64), generator=gen,
                           device="cuda")
    out = []
    for name in ("copy", "masters", "masters", "copy"):
        model = models[name]
        cache = zero_cache(model, 8)
        with torch.no_grad():
            model(prompt, cache=cache)
            reset_cursors(cache, 64)
            tok = prompt[:, -1:]
            for _ in range(3):
                model(tok, cache=cache)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                model(tok, cache=cache)
            torch.cuda.synchronize()
        out.append(dict(weights=name, step_ms=(time.perf_counter() - t0)
                        / steps * 1e3, param_mib=sum(
                            p.numel() * p.element_size()
                            for p in model.parameters()) / 2**20))
    return out


#: --order's summations of s = q k^T (and the backward's dp = do v^T) in
#: the plain versions: as the kernels sum them, as f32 FMAs (cuBLAS), and
#: in f64 rounded once to f32
ORDER_DOTS = {
    "tensor-core": VA._dot,
    "f32": VA._dot_f32,
    "f64": lambda a, b: torch.einsum("bqhd,bkhd->bhqk", a.double(),
                                     b.double()).float(),
}


def _order_lines(label, names, got, plain) -> list[str]:
    """``got`` (the kernels' outputs) against ``plain[n]`` for every
    summation ``n`` of :data:`ORDER_DOTS`, and the f32 sums against the
    f64 ones: one line each, an element-wise reading per output."""
    pairs = [("kernels", got, n) for n in ORDER_DOTS]
    pairs.append(("plain (f32 sums)", plain["f32"], "f64"))
    lines = []
    for a_name, a, b_name in pairs:
        parts = [f"{g} {elem_reading(x, y)}"
                 f"{'' if max_err(x, y)[1] else ' (over the bar)'}"
                 for g, x, y in zip(names, a, plain[b_name])]
        lines.append(f"{label}: {a_name} vs plain ({b_name} sums): "
                     + "; ".join(parts))
    return lines


def order_probe(gen) -> list[str]:
    """At every vmem and flash parity case in bf16: each kernel's outputs
    that round p (the two forwards' o, vmem's dq, dk, dv) against its
    plain version with s (and dp) summed each way of :data:`ORDER_DOTS`,
    and the f32 sums against the f64 ones, each with its element-wise
    reading and whether it holds the bar: the size of an order-only
    difference."""
    from tpudist_torch.ops.attention import repeat_kv

    lines = []
    for kind, cases in (("vmem", ATTN_CASES), ("flash", FLASH_CASES)):
        mod = FA if kind == "flash" else VA
        fwd_cuda = getattr(mod, f"{kind}_fwd_cuda")
        fwd_plain = getattr(mod, f"{kind}_fwd_plain")
        for tag, b, s, h, h_kv, causal, kv_len, strided, d in cases:
            q, k, v, do = attn_inputs(gen, b, s, h, h_kv, torch.bfloat16,
                                      strided=strided, d=d)
            if kind == "flash":
                k, v = repeat_kv(q, k, v)
            kw = dict(causal=causal, kv_len=kv_len or s, scale=VA._scale(d))
            o, lse = fwd_cuda(q, k, v, **kw)
            plain = {n: fwd_plain(q, k, v, dot=f, **kw)[:1]
                     for n, f in ORDER_DOTS.items()}
            lines += _order_lines(f"{kind} forward {tag}", ("o",), (o,),
                                  plain)
            if kind == "vmem":
                got = VA.vmem_bwd_cuda(q, k, v, o, do, lse, **kw)
                plain = {n: VA.vmem_bwd_plain(q, k, v, o, do, lse, dot=f,
                                              **kw)
                         for n, f in ORDER_DOTS.items()}
                lines += _order_lines(f"vmem backward {tag}",
                                      ("dq", "dk", "dv"), got, plain)
    return lines


#: --ab's cases: rows 7-8 and 3-4 of PERF.md's kernel table, the forward
#: and backward at the long-context and GPT-2 training shapes
AB_CASES = (("flash", FB, FS), ("vmem", B, S))


def _turns(calls, libs, flush, n) -> tuple[dict, dict]:
    """Each side's parity error of ``call(lib)`` against ``plain()``, and
    its median device times of ``n`` calls in turns (A, B, B, A)."""
    call, plain = calls
    want = plain()
    err = {who: max(max_err(g, w)[0] for g, w in zip(call(lib), want)
                    if g is not None)
           for who, lib in libs.items()}
    del want
    ms = {"A": [], "B": []}
    for who in "ABBA":
        ms[who].append(DB.device_ms(lambda: call(libs[who]), flush, n,
                                    spin_cycles=SPIN_CYCLES))
    return ms, err


def kernels_ab(src_dir: Path, n: int = DB.N_TIMED) -> list[dict]:
    """Kernels built from ``src_dir``'s sources as A against this
    checkout's as B, in turns (A, B, B, A), for each source ``src_dir``
    holds: ``layernorm.cu``'s plain and pre-norm forwards at 8192 x 768
    bf16; ``flash_attention.cu`` / ``vmem_attention.cu`` (and the headers
    beside them), the bf16 forward and backward at :data:`AB_CASES`. Each
    entry has the median device time of ``n`` calls per turn and each
    side's parity error against the plain version. Both attention
    backwards take this checkout's forward's (o, lse)."""
    from tpudist_torch.csrc import build

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = []
    if (src_dir / "layernorm.cu").exists():
        libs = {"A": build.load(str((src_dir / "layernorm.cu").resolve())),
                "B": None}
        t = ln_inputs(gen, ROWS, WIDTH, torch.bfloat16)
        for name, y in (("layernorm_fwd", None),
                        ("layernorm_fwd_prenorm", t["y"])):
            kw = dict(eps=EPS, rms=False, out_dtype=torch.bfloat16,
                      want_residual=y is not None)
            ms, err = _turns(
                (lambda lib: LN.layernorm_fwd_cuda(t["x"], y, t["scale"],
                                                   t["bias"], lib=lib, **kw),
                 lambda: LN.layernorm_fwd_plain(t["x"], y, t["scale"],
                                                t["bias"], **kw)),
                libs, flush, n)
            out.append(dict(name=name, shape=f"{ROWS} x {WIDTH} rows, bf16",
                            ms=ms, err=err))
    for kind, b, s in AB_CASES:
        if not (src_dir / f"{kind}_attention.cu").exists():
            continue
        mod = FA if kind == "flash" else VA
        fwd = getattr(mod, f"{kind}_fwd_cuda")
        bwd = getattr(mod, f"{kind}_bwd_cuda")
        libs = {"A": build.load(str((src_dir / f"{kind}_attention.cu")
                                    .resolve())), "B": None}
        q, k, v, do = attn_inputs(gen, b, s, H, H, torch.bfloat16,
                                  strided=True)
        kw = dict(causal=True, kv_len=s, scale=VA._scale(D))
        o, lse = fwd(q, k, v, **kw)
        calls = (
            ("fwd", lambda lib: fwd(q, k, v, lib=lib, **kw),
             lambda: getattr(mod, f"{kind}_fwd_plain")(q, k, v, **kw)),
            ("bwd", lambda lib: bwd(q, k, v, o, do, lse, lib=lib, **kw),
             lambda: getattr(mod, f"{kind}_bwd_plain")(q, k, v, o, do, lse,
                                                       **kw)))
        for direction, call, plain in calls:
            ms, err = _turns((call, plain), libs, flush, n)
            out.append(dict(name=f"{kind}_attention_{direction}",
                            shape=f"B {b}, H {H}, S {s}, D {D}, causal, bf16",
                            ms=ms, err=err))
    return out


#: --head's vocabularies: GPT-2's, whose odd row count leaves no operand
#: row of the head's products 16-byte aligned, and its next multiple of 64
HEAD_VOCABS = (50257, 50304)


def _cuda_kernels(fn) -> list[str]:
    """The names of the device kernels one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:60] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def head_probe(n: int = DB.N_TIMED) -> list[str]:
    """The weight-tied head's three products at GPT-2's S 1024 step (x
    [8192, 768] and wte [V, 768] in bf16, f32 sums: the logits, dx = g wte
    and dwte = g^T x) at each of :data:`HEAD_VOCABS`, in turns (50257,
    50304, 50304, 50257), with the kernels cuBLAS picks; then the whole
    bf16 backward at V 50257 with the cotangent rounded to one bf16 (the
    old backward) and carried as hi + lo
    (:func:`tpudist_torch.models.gpt2.tied_head_grads`), in turns (old,
    new, new, old). Device times as the kernel times above."""
    from tpudist_torch.models.gpt2 import _mm_f32, tied_head_grads

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    bf = torch.bfloat16
    x = _rand(gen, (ROWS, WIDTH), bf)
    tables = {v: (_rand(gen, (v, WIDTH), bf, 0.02),
                  _rand(gen, (ROWS, v), bf, 1e-6)) for v in HEAD_VOCABS}
    products = (("logits = x wte^T", lambda w, g: _mm_f32(x, w.t())),
                ("dx = g wte", lambda w, g: _mm_f32(g, w)),
                ("dwte = g^T x", lambda w, g: _mm_f32(g.t(), x)))
    lines = []
    for name, fn in products:
        ms = {v: [] for v in HEAD_VOCABS}
        for v in (HEAD_VOCABS[0], HEAD_VOCABS[1], HEAD_VOCABS[1],
                  HEAD_VOCABS[0]):
            w, g = tables[v]
            ms[v].append(DB.device_ms(lambda: fn(w, g), flush, n,
                                      spin_cycles=SPIN_CYCLES))
        for v in HEAD_VOCABS:
            w, g = tables[v]
            lines.append(f"{name} at V {v}: {ms[v][0]:.4f} / {ms[v][1]:.4f} "
                         f"ms; kernels {_cuda_kernels(lambda: fn(w, g))}")
    w = tables[HEAD_VOCABS[0]][0]
    g32 = _rand(gen, (ROWS, HEAD_VOCABS[0]), torch.float32, 1e-6)
    del tables

    def old():
        gb = g32.to(bf)
        return _mm_f32(gb, w).to(bf), _mm_f32(gb.t(), x).to(bf)

    def new():
        dx, dw = tied_head_grads(g32, x, w, _mm_f32)
        return dx.to(bf), dw.to(bf)

    ms = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        ms[who].append(DB.device_ms(old if who == "old" else new, flush, n,
                                    spin_cycles=SPIN_CYCLES))
    lines.append(f"head backward at V {HEAD_VOCABS[0]}: g as one bf16 "
                 f"{ms['old'][0]:.4f} / {ms['old'][1]:.4f} ms, g as hi + lo "
                 f"{ms['new'][0]:.4f} / {ms['new'][1]:.4f} ms (turns old new "
                 f"new old)")
    return lines


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpudist_torch.ops.lm_kernels_bench")
    p.add_argument("--parity", action="store_true", help="parity only")
    p.add_argument("--train_ab", action="store_true",
                   help="only the end-to-end A/B of the two paths")
    p.add_argument("--seq_len", default=1024, type=int,
                   help="--train_ab's sequence length (module docstring)")
    p.add_argument("--decode_ab", action="store_true",
                   help="only the decode step on masters vs the copy")
    p.add_argument("--order", action="store_true",
                   help="only the bf16 kernels that round p against their "
                   "plain versions with s (and dp) summed three ways")
    p.add_argument("--ab", type=Path, default=None, metavar="DIR",
                   help="only the kernels built from DIR's sources "
                   "(layernorm.cu, flash_attention.cu, vmem_attention.cu) "
                   "against this checkout's, in turns")
    p.add_argument("--head", action="store_true",
                   help="only the tied head's products at V 50257 and "
                   "50304, and its backward old and new, in turns")
    args = p.parse_args(argv)
    from tpudist_torch.csrc import build

    print(card())
    if args.order:
        for line in order_probe(torch.Generator(device="cuda").manual_seed(0)):
            print(line)
        return 0
    if args.head:
        for line in head_probe():
            print(f"{line}  [{card()}]")
        return 0
    if args.ab:
        for r in kernels_ab(args.ab):
            a, b = (r["ms"][w] for w in "AB")
            print(f"{r['name']} [{r['shape']}]: {args.ab} (A) "
                  f"{a[0]:.4f} / {a[1]:.4f} ms, this checkout (B) "
                  f"{b[0]:.4f} / {b[1]:.4f} ms (medians of {DB.N_TIMED} "
                  f"calls, turns A B B A); A / B {sum(a) / sum(b):.2f}x; "
                  f"max_abs_err A {r['err']['A']:.3e}, B {r['err']['B']:.3e}"
                  f"  [{card()}]")
        return 0
    if args.decode_ab:
        for r in decode_ab():
            print(f"{r['weights']}: {r['step_ms']:.4f} ms per decode step, "
                  f"parameters {r['param_mib']:.1f} MiB")
        return 0
    if args.train_ab:
        for r in train_ab(args.seq_len):
            if "oom" in r:
                print(f"{r['path']}: out of memory at S {args.seq_len} "
                      f"(peak {r['peak_gib']:.2f} GiB): {r['oom']}")
                continue
            print(f"{r['path']}: S {args.seq_len}, step at g_step 15 "
                  f"{r['step_ms']:.2f} ms, {r['tokens_per_s']:.1f} tokens/s "
                  f"over the run, final loss {r['final_loss']:.4f}, peak "
                  f"{r['peak_gib']:.2f} GiB")
        return 0
    build.build_all()
    for src in ("layernorm.cu", "vmem_attention.cu", "flash_attention.cu"):
        info = build.build_info[src]
        print(f"{src}: nvcc {info['seconds']:.2f} s")
        for r in build.register_report(src):
            print(f"  {r['kernel']}: {r['registers']} registers, "
                  f"{r['spill_stores']} / {r['spill_loads']} bytes spill "
                  f"stores / loads")
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for parity in (ln_parity, attn_parity, flash_parity):
        for name, got, want in parity(gen):
            torch.cuda.synchronize()
            err, ok = max_err(got, want)
            extra = (f", {elem_reading(got, want)}"
                     if want.dtype == torch.bfloat16 else "")
            print(f"  {name}: max_abs_err {err:.3e}{extra} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(name)
    if failed or args.parity:
        print(f"parity failures: {failed}")
        return 1 if failed else 0
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for case in (*timing_cases(gen), *flash_timing_cases(gen)):
        t = time_case(case, flush)
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"{case['name']} [{case['shape']}]: kernel {t['kernel_ms']:.4f}"
              f" ms, bound {case['bound_ms']:.4f} ms ({case['bound_by']}), "
              f"plain {t['plain_ms']:.4f} ms, library {lib} ms, max_abs_err "
              f"{case['max_abs_err']:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
