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
