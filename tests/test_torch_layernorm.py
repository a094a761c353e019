"""The port's fused residual-add + LayerNorm (tpudist_torch.ops.layernorm)
against the JAX reference's Pallas kernel in interpret mode
(tpudist.ops.layernorm), on the same numpy inputs: the three
compositions, RMS on and off, widths 64 and 200 (a width that is no
multiple of the reference's 128-lane tile), float32 and bfloat16, the
forward outputs and every gradient.

Tolerance: the repo's kernel-parity rule (``kernel_parity``): 2e-5
absolute and relative in float32; in bfloat16 2% of the reference's
largest magnitude, since both round a float32 interior to bf16 once and
may land one bf16 ulp apart.

On the CPU every wrapper takes the kernel's plain version; the kernel
itself is held to that plain version on the card by ``chip_smoke.py``."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.ops.layernorm import fused_layernorm as jax_fused_layernorm
from tpudist_torch.ops import layernorm as LN
from tpudist_torch.ops.layernorm import fused_layernorm

EPS = 1e-5


def _inputs(d, seed, shape=(3, 5)):
    rng = np.random.Generator(np.random.PCG64(seed))
    f = lambda *s, scale=1.0, shift=0.0: (
        rng.standard_normal(s) * scale + shift).astype(np.float32)
    return dict(x=f(*shape, d), y=f(*shape, d), scale=f(d, scale=0.2, shift=1.0),
                bias=f(d, scale=0.2), g=f(*shape, d), gr=f(*shape, d))


def _jax(comp, t, dtype, rms):
    """The reference's outputs and gradients (x, y, scale, bias)."""
    cast = lambda a: jnp.asarray(a, dtype)
    x, y, g, gr = (cast(t[k]) for k in ("x", "y", "g", "gr"))
    scale, bias = jnp.asarray(t["scale"]), jnp.asarray(t["bias"])
    kw = dict(eps=EPS, rms=rms)

    def fn(x, y, scale, bias):
        if comp == "plain":
            return (jax_fused_layernorm(x, scale, bias, **kw),)
        if comp == "pre":
            return jax_fused_layernorm(x, scale, bias, residual=y, **kw)
        return (jax_fused_layernorm(x, scale, bias, residual=y,
                                    return_residual=False, **kw),)

    outs, vjp = jax.vjp(fn, x, y, scale, bias)
    cts = (g, gr)[:len(outs)]
    grads = vjp(cts)
    return outs, grads


def _port(comp, t, dtype, rms):
    cast = lambda a: torch.tensor(a).to(dtype).requires_grad_()
    x, y = cast(t["x"]), cast(t["y"])
    scale = torch.tensor(t["scale"]).requires_grad_()
    bias = torch.tensor(t["bias"]).requires_grad_()
    kw = dict(eps=EPS, rms=rms)
    if comp == "plain":
        outs = (fused_layernorm(x, scale, bias, **kw),)
    elif comp == "pre":
        outs = fused_layernorm(x, scale, bias, residual=y, **kw)
    else:
        outs = (fused_layernorm(x, scale, bias, residual=y,
                                return_residual=False, **kw),)
    cts = tuple(torch.tensor(t[k]).to(dtype) for k in ("g", "gr"))[:len(outs)]
    inputs = (x, y, scale, bias)
    grads = torch.autograd.grad(outs, inputs, cts, allow_unused=True)
    return outs, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 200])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("comp", ["plain", "pre", "post"])
def test_matches_the_reference_kernel(comp, rms, d, dtype, kernel_parity):
    t = _inputs(d, seed=d + 7 * rms)
    want_out, want_grads = _jax(comp, t, jnp.dtype(dtype), rms)
    got_out, got_grads = _port(comp, t, getattr(torch, dtype), rms)
    assert len(got_out) == len(want_out)
    for got, want in zip(got_out, want_out):
        assert got.dtype == getattr(torch, dtype)
        kernel_parity(got.detach().float().numpy(), np.asarray(want))
    names = ("dx", "dy", "dscale", "dbias")
    for name, got, want in zip(names, got_grads, want_grads):
        want = np.asarray(want)
        if name == "dy" and comp == "plain" or name == "dbias" and rms:
            # no residual operand / RMS has no bias: no gradient flows
            assert got is None and not want.any(), name
            continue
        kernel_parity(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("comp", ["plain", "pre"])
def test_backward_at_a_main_path_row_count(comp, rms, dtype, kernel_parity):
    """The backward at 2048 x 768 rows (GPT-2's width, a quarter of its
    8192 rows) against the reference kernel in interpret mode: dx (and dy),
    dscale and dbias under the kernel-parity rule.

    Why the column sums agree within it: the port adds the rows' float32
    terms g * x^ and g in float64 and rounds once; the reference adds each
    256-row block's float32 column sums into float32 scratch over 8 grid
    steps. That float32 order moves a sum of 2048 terms of magnitude ~1 by
    a few 1e-6, so the worst column sits at 0.3-0.6 of 2e-5 absolute plus
    2e-5 relative (measured at these inputs), not past it."""
    t = _inputs(768, seed=11 + rms, shape=(2048,))
    _, want_grads = _jax(comp, t, jnp.dtype(dtype), rms)
    _, got_grads = _port(comp, t, getattr(torch, dtype), rms)
    for name, got, want in zip(("dx", "dy", "dscale", "dbias"), got_grads,
                               want_grads):
        want = np.asarray(want)
        if name == "dy" and comp == "plain" or name == "dbias" and rms:
            assert got is None and not want.any(), name
            continue
        kernel_parity(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [2560, 4096, 4100, 8192])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("comp", ["plain", "pre"])
def test_wide_rows_match_the_reference_kernel(comp, rms, d, dtype,
                                              kernel_parity):
    """A few rows past the register kernels' 2048 (on the card the wide
    kernels), at the widths chip_smoke phase 34 runs: 2560, 4096
    (Llama-7B/8B's), 4100 (no multiple of 8: the element-wise path) and
    8192 (Llama-2-70B's, 16 columns a thread), against the reference
    kernel in interpret mode, which pads D to its lanes and shrinks its
    row block: n (and r), dx (and dy), dscale and dbias under the
    kernel-parity rule."""
    rows = 16 if d == 4096 else 4
    t = _inputs(d, seed=23 + rms + (0 if d == 4096 else d), shape=(rows,))
    want_out, want_grads = _jax(comp, t, jnp.dtype(dtype), rms)
    got_out, got_grads = _port(comp, t, getattr(torch, dtype), rms)
    for got, want in zip(got_out, want_out):
        kernel_parity(got.detach().float().numpy(), np.asarray(want))
    for name, got, want in zip(("dx", "dy", "dscale", "dbias"), got_grads,
                               want_grads):
        want = np.asarray(want)
        if name == "dy" and comp == "plain" or name == "dbias" and rms:
            assert got is None and not want.any(), name
            continue
        kernel_parity(got.float().numpy(), want)
    assert LN.MAX_REG_D < d <= LN.MAX_D


def test_row_statistics_round_each_sum_once():
    """The backward's statistics (``_row_stats(exact=True)``), the rounding
    the backward kernel follows: each row sum taken in float64 and rounded
    to float32 once; the products by 1/D, the centring, the squares and eps
    in float32. The forward's (the default) sum each row in float32."""
    rng = np.random.Generator(np.random.PCG64(0))
    r = (rng.standard_normal((64, 200)) * 3 + 1).astype(np.float32)
    inv_d = np.float32(1.0 / 200)
    rowsum = lambda a: a.astype(np.float64).sum(-1, keepdims=True).astype(
        np.float32)
    mean = rowsum(r) * inv_d
    var = rowsum((r - mean) * (r - mean)) * inv_d
    rt = torch.from_numpy(r)
    got_mean, got_rstd = LN._row_stats(rt, eps=EPS, rms=False, exact=True)
    assert np.array_equal(got_mean.numpy(), mean)
    assert torch.equal(got_rstd, torch.rsqrt(torch.from_numpy(var) + EPS))
    _, rms_rstd = LN._row_stats(rt, eps=EPS, rms=True, exact=True)
    assert torch.equal(rms_rstd, torch.rsqrt(
        torch.from_numpy(rowsum(r * r) * inv_d) + EPS))
    f32_mean, _ = LN._row_stats(rt, eps=EPS, rms=False)
    assert torch.equal(f32_mean, rt.sum(-1, keepdim=True) * float(inv_d))


def _sums_in_two_orders(t, exact):
    """Row sums of float32 ``t [N, 768]`` in two orders: left to right,
    and the backward kernel's (lane l adds its 24 columns (l + 32 j) * 8 +
    k in order, then a butterfly over the 32 lanes). ``exact``: each in
    float64, rounded to float32 once; else in float32."""
    n = t.shape[0]
    acc = torch.float64 if exact else torch.float32
    cols = t.T.contiguous().to(acc)
    seq = cols[0].clone()
    for c in range(1, cols.shape[0]):
        seq += cols[c]
    lanes = t.to(acc).view(n, 3, 32, 8).permute(0, 2, 1, 3).reshape(n, 32, 24)
    lane = lanes[:, :, 0].clone()
    for j in range(1, 24):
        lane += lanes[:, :, j]
    for o in (16, 8, 4, 2, 1):
        lane = lane + lane[:, torch.arange(32) ^ o]
    return seq.float()[:, None], lane[:, :1].float()


def test_backward_statistics_in_two_float32_orders_split_dscale():
    """Why the backward's plain version and kernel take their row sums in
    float64 and round once: at chip_smoke phase 11's 65536 x 768 rows, row
    sums in float32 in two orders (left to right, and the kernel's) give
    statistics an ulp apart in most rows, and the dscale column sums part
    by more than the float32 parity rule (2e-5 absolute + 2e-5 relative) in
    some of the phase's eight distinct comparisons (r = x or x + y, RMS off
    and on, f32 and bf16 rows; the compositions share dscale). Summed in
    float64 and rounded once, the two orders give equal statistics, so
    equal dscale, in every row."""
    n, d, chunk = 65536, 768, 8192
    inv_d = float(np.float32(1.0 / d))
    rng = np.random.Generator(np.random.PCG64(11))
    cases = [(dt, res, rms) for dt in (torch.float32, torch.bfloat16)
             for res in (False, True) for rms in (False, True)]
    ds = {(c, exact): [torch.zeros(d, dtype=torch.float64) for _ in range(2)]
          for c in cases for exact in (False, True)}
    for _ in range(n // chunk):
        x, y, g = (torch.from_numpy(rng.standard_normal((chunk, d),
                                                        dtype=np.float32))
                   for _ in range(3))
        for c in cases:
            dt, res, rms = c
            r = ((x + y) if res else x).to(dt).float()
            gf = g.to(dt).float()
            for exact in (False, True):
                if rms:
                    means = [torch.zeros_like(r[:, :1])] * 2
                    sq = _sums_in_two_orders(r * r, exact)
                else:
                    means = [s * inv_d for s in _sums_in_two_orders(r, exact)]
                    sq = [_sums_in_two_orders((r - m) * (r - m), exact)[k]
                          for k, m in enumerate(means)]
                for k, m in enumerate(means):
                    xhat = (r - m) * torch.rsqrt(sq[k] * inv_d + EPS)
                    ds[c, exact][k] += (gf * xhat).double().sum(0)
    over = {}
    for c in cases:
        a, b = (t.float() for t in ds[c, False])
        over[c] = float(((a - b).abs() / (2e-5 + 2e-5 * a.abs())).max())
        e0, e1 = ds[c, True]
        assert torch.equal(e0, e1), c
    assert max(over.values()) > 1, over


@pytest.mark.parametrize("comp", ["plain", "pre", "post"])
def test_plain_versions_are_the_wrapped_functions(comp):
    """The autograd compositions are exactly the plain forward and
    backward on flattened rows (the CPU path of the kernels)."""
    t = _inputs(64, seed=3)
    x, y = torch.tensor(t["x"]), torch.tensor(t["y"])
    scale, bias = torch.tensor(t["scale"]), torch.tensor(t["bias"])
    y2 = None if comp == "plain" else y.reshape(-1, 64)
    n, r = LN.layernorm_fwd_plain(x.reshape(-1, 64), y2, scale, bias, eps=EPS,
                                  rms=False, out_dtype=torch.float32,
                                  want_residual=comp == "pre")
    out = fused_layernorm(x, scale, bias, eps=EPS,
                          residual=None if comp == "plain" else y,
                          return_residual=comp == "pre")
    if comp == "pre":
        assert torch.equal(out[0].reshape(-1, 64), n)
        assert torch.equal(out[1].reshape(-1, 64), r)
    else:
        assert torch.equal(out.reshape(-1, 64), n) and r is None


def test_module_holds_the_layernorm_parameter_names():
    """GPT-2's LayerNorm holds the reference's ``scale`` and ``bias`` and
    runs both paths over them (what lets the model's fused_ln knob reuse
    them): its fused pre-norm gives ``n`` in the compute dtype and
    ``r = x + residual`` in x's dtype, the kernel's function of the same
    parameters."""
    from tpudist_torch.models.gpt2 import LayerNorm

    ln = LayerNorm(48)
    assert dict(ln.named_parameters()).keys() == {"scale", "bias"}
    with torch.no_grad():
        ln.scale.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
        ln.bias.normal_(generator=torch.Generator().manual_seed(2))
    x = torch.randn(2, 3, 48, generator=torch.Generator().manual_seed(0))
    n, r = ln.fused(x, torch.bfloat16, residual=x)
    assert n.dtype == torch.bfloat16 and r.dtype == torch.float32
    torch.testing.assert_close(r, 2 * x)
    want = fused_layernorm(2 * x, ln.scale, ln.bias, eps=ln.eps,
                           out_dtype=torch.bfloat16)
    assert torch.equal(n, want)


def test_validation_errors():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="scale shape"):
        fused_layernorm(x, torch.ones(4))
    with pytest.raises(ValueError, match="residual shape"):
        fused_layernorm(x, torch.ones(8), residual=torch.zeros(2, 4))
    with pytest.raises(ValueError, match="needs a residual"):
        fused_layernorm(x, torch.ones(8), return_residual=True)


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """The wrappers route on the tensor's device alone: a CUDA tensor goes
    to the kernel wrapper, which refuses anything but CUDA tensors (so no
    failure there can fall back to the plain path); the plain versions
    never count launches."""
    seen = []
    monkeypatch.setattr(LN, "layernorm_fwd_cuda", lambda *a, **k: seen.append("fwd"))
    monkeypatch.setattr(LN, "layernorm_bwd_cuda", lambda *a, **k: seen.append("bwd"))
    card = types.SimpleNamespace(is_cuda=True)
    LN.layernorm_fwd(card, None, None, None, eps=EPS, rms=False,
                     out_dtype=None, want_residual=False)
    LN.layernorm_bwd(card, None, None, None, eps=EPS, rms=False)
    assert seen == ["fwd", "bwd"]
    monkeypatch.undo()
    LN.reset_launch_counts()
    x, s = torch.randn(4, 8), torch.ones(8)
    with pytest.raises(ValueError, match="on"):
        LN.layernorm_fwd_cuda(x, None, s, None, eps=EPS, rms=False,
                              out_dtype=torch.float32, want_residual=False)
    with pytest.raises(ValueError, match="on"):
        LN.layernorm_bwd_cuda(x, x, None, s, eps=EPS, rms=False)
    fused_layernorm(x.requires_grad_(), s, residual=x, eps=EPS)[0].sum().backward()
    assert set(LN.launch_counts.values()) == {0}
