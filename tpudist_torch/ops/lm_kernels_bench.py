"""Parity and device times of the GPT-2 training kernels on the card.

    python -m tpudist_torch.ops.lm_kernels_bench            # parity, then times
    python -m tpudist_torch.ops.lm_kernels_bench --parity   # parity only
    python -m tpudist_torch.ops.lm_kernels_bench --train_ab # end to end, in turns
    python -m tpudist_torch.ops.lm_kernels_bench --decode_ab # serving copy, in turns

The kernels are the fused residual-add + LayerNorm forward and backward
(:mod:`tpudist_torch.ops.layernorm`) and the whole-row attention forward
and backward (:mod:`tpudist_torch.ops.vmem_attention`).

Parity holds each kernel against its plain PyTorch version on the same
inputs on the card, under the repo's kernel-parity rule (2e-5 absolute
plus relative in float32, 2% of the plain result's largest magnitude in
bfloat16) and, for bfloat16 outputs, element by element as well: within
:data:`ELEM_ULPS` bf16 ulps of the plain value plus :data:`ELEM_ATOL` of
its largest magnitude. Cases: LayerNorm at GPT-2's 8192 x 768 rows and a
ragged 1000 x 200, the three compositions, RMS on and off; attention at
GPT-2's B 8, H 12, S 1024, D 64 causal (q, k, v strided views of one qkv
tensor, as the model passes them), S 197 non-causal, ``kv_len`` < S, GQA
with 4 K/V heads, and head dims 32, 80 and 128; float32 and bfloat16
throughout.

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

``--train_ab`` trains GPT-2 124M (bf16, batch 8, S 1024, 16 steps, one
process, no profiler) on the kernels' path (``--fused all --attn auto``)
and on the dense path (``--fused optimizer --attn xla``: dense attention
and the unfused LayerNorm, the fused AdamW kept) in turns (kernels,
dense, dense, kernels), and prints each run's step time at g_step 15
(the TSV), its tokens/s over the run and its peak device memory. Both
train on :func:`token_file`'s fixed text.

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
from tpudist_torch.ops import layernorm as LN
from tpudist_torch.ops import vmem_attention as VA

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: about 10 ms at the H100's clock: longer than enqueueing a plain version
SPIN_CYCLES = 20_000_000
EPS = 1e-5
B, H, S, D = 8, 12, 1024, 64
ROWS, WIDTH = B * S, H * D


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


def ln_inputs(gen, n, d, dtype):
    """x, y, scale, bias, g, gr for ``n`` rows of width ``d``."""
    return dict(x=_rand(gen, (n, d), dtype), y=_rand(gen, (n, d), dtype),
                scale=_rand(gen, (d,), torch.float32, 0.1, 1.0),
                bias=_rand(gen, (d,), torch.float32, 0.1),
                g=_rand(gen, (n, d), dtype), gr=_rand(gen, (n, d), dtype))


def ln_parity(gen):
    """Yield ``(name, got, want)`` for every LayerNorm parity case."""
    for n, d in ((ROWS, WIDTH), (1000, 200)):
        for dtype in (torch.float32, torch.bfloat16):
            t = ln_inputs(gen, n, d, dtype)
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
                    tag = (f"ln {n}x{d} {str(dtype)[6:]} {comp}"
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

    q, k, v, do = attn_inputs(gen, B, S, H, H, dt, strided=True)
    akw = dict(causal=True, kv_len=S, scale=VA._scale(D))
    qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
    tensor = B * S * H * D * item
    lse_bytes = B * H * S * 4
    # causal: the score entries the mask keeps, s (s + 1) / 2 per head
    kept = B * H * S * (S + 1) / 2
    got, want = VA.vmem_fwd_cuda(q, k, v, **akw), VA.vmem_fwd_plain(q, k, v,
                                                                     **akw)
    o, lse = got
    cases.append(dict(
        name="vmem_attention_fwd",
        kernel=lambda: VA.vmem_fwd_cuda(q, k, v, **akw),
        plain=lambda: VA.vmem_fwd_plain(q, k, v, **akw),
        library=lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                       is_causal=True),
        max_abs_err=max(max_err(a, b)[0] for a, b in zip(got, want)),
        shape=f"B {B}, H {H}, S {S}, D {D}, causal, bf16",
        **bound(4 * tensor + lse_bytes, 2 * 2 * D * kept, dt)))
    del want
    ql, kl, vl = (a.detach().clone().requires_grad_() for a in (qh, kh, vh))
    lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    doh = do.transpose(1, 2)
    got = VA.vmem_bwd_cuda(q, k, v, o, do, lse, **akw)
    want = VA.vmem_bwd_plain(q, k, v, o, do, lse, **akw)
    cases.append(dict(
        name="vmem_attention_bwd",
        kernel=lambda: VA.vmem_bwd_cuda(q, k, v, o, do, lse, **akw),
        plain=lambda: VA.vmem_bwd_plain(q, k, v, o, do, lse, **akw),
        library=lambda: torch.autograd.grad(lo, (ql, kl, vl), doh,
                                            retain_graph=True),
        max_abs_err=max(max_err(a, b)[0] for a, b in zip(got, want)),
        shape=f"B {B}, H {H}, S {S}, D {D}, causal, bf16",
        **bound(8 * tensor + lse_bytes, 5 * 2 * D * kept, dt)))
    return cases


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


#: --train_ab's two paths: (name, train_gpt2 flags)
AB_PATHS = (("kernels", ["--fused", "all", "--attn", "auto"]),
            ("dense", ["--fused", "optimizer", "--attn", "xla"]))


def train_ab(steps: int = 16) -> list[dict]:
    """The two paths of :data:`AB_PATHS` in turns (A, B, B, A)."""
    from tpudist_torch import train_gpt2

    out = []
    with tempfile.TemporaryDirectory() as log_dir:
        tokens = token_file(Path(log_dir) / "text.bin", steps * 8 * 1024)
        for n, i in enumerate((0, 1, 1, 0)):
            name, flags = AB_PATHS[i]
            torch.cuda.reset_peak_memory_stats()
            with contextlib.redirect_stdout(io.StringIO()):
                _, losses = train_gpt2.main([
                    *flags, "--bf16", "--batch_size", "8", "--seq_len",
                    "1024", "--tokens", str(tokens), "--no_profiler",
                    "--JobID", f"AB{n}", "--log_dir", log_dir])
            rows = (Path(log_dir) / f"AB{n}_8_0.log").read_text().splitlines()
            eps15 = float(rows[3].split("\t")[4])
            train_s = float(rows[-1].split("\t")[1])
            out.append(dict(
                path=name, step_ms=8 / eps15 * 1e3,
                tokens_per_s=len(losses) * 8 * 1024 / train_s,
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
    p.add_argument("--decode_ab", action="store_true",
                   help="only the decode step on masters vs the copy")
    args = p.parse_args(argv)
    from tpudist_torch.csrc import build

    print(card())
    if args.decode_ab:
        for r in decode_ab():
            print(f"{r['weights']}: {r['step_ms']:.4f} ms per decode step, "
                  f"parameters {r['param_mib']:.1f} MiB")
        return 0
    if args.train_ab:
        for r in train_ab():
            print(f"{r['path']}: step at g_step 15 {r['step_ms']:.2f} ms, "
                  f"{r['tokens_per_s']:.1f} tokens/s over the run, final loss "
                  f"{r['final_loss']:.4f}, peak {r['peak_gib']:.2f} GiB")
        return 0
    build.build_all()
    for src in ("layernorm.cu", "vmem_attention.cu"):
        info = build.build_info[src]
        print(f"{src}: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print("  " + line.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for parity in (ln_parity, attn_parity):
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
    for case in timing_cases(gen):
        t = time_case(case, flush)
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"{case['name']} [{case['shape']}]: kernel {t['kernel_ms']:.4f}"
              f" ms, bound {case['bound_ms']:.4f} ms ({case['bound_by']}), "
              f"plain {t['plain_ms']:.4f} ms, library {lib} ms, max_abs_err "
              f"{case['max_abs_err']:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
