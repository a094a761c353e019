"""The port's whole-row attention (tpudist_torch.ops.vmem_attention)
against the JAX reference's Pallas kernel in interpret mode
(tpudist.ops.vmem_attention), on the same numpy inputs: S 128 (aligned),
197 (ViT's padding) and 256, causal and not, a ``kv_len`` below S, and
grouped K/V heads; the output and the gradients of q, k and v, in float32
and bfloat16. Then the S_pad > 1024 refusal and ``multi_head_attention``'s
``auto`` routing around it. Last, the bf16 backward's tensor-core
arithmetic (``tests/torch_attention_model.py``: p and ds rounded to one
bf16, f32 sums) against the reference's VJP, and the bf16 forward's (p
rounded to one bf16 against the exact row max, l from the f32 p) against
``_vmem_fwd_raw``, under ``lm_kernels_bench``'s element-wise bar, GQA and
MQA included.

Tolerance: the repo's kernel-parity rule (``kernel_parity``): 2e-5
absolute and relative in float32; in bfloat16 2% of the reference's
largest magnitude (p and ds are rounded to bf16 before their products on
both sides, and the sums run in different orders).

On the CPU the wrappers take the kernels' plain versions; the kernels are
held to those on the card by ``chip_smoke.py``."""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.ops.attention import multi_head_attention as jax_mha
from tpudist.ops.vmem_attention import _vmem_fwd_raw, _vmem_vjp_bwd
from tpudist.ops.vmem_attention import vmem_attention as jax_vmem
from torch_attention_model import (f32_dot, mma_bwd_model, mma_fwd_model,
                                   one_bf16, xla_dot)
from tpudist_torch.ops import flash_attention as FA
from tpudist_torch.ops import lm_kernels_bench as LB
from tpudist_torch.ops import vmem_attention as VA
from tpudist_torch.ops.attention import dot_product_attention, multi_head_attention
from tpudist_torch.ops.vmem_attention import vmem_attention

D = 32


def _qkv(b, s, h, h_kv, seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    f = lambda heads: rng.standard_normal((b, s, heads, D)).astype(np.float32)
    return f(h), f(h_kv), f(h_kv), f(h)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,causal,kv_len,h,h_kv", [
    (128, True, None, 2, 2),
    (128, False, None, 4, 4),
    (197, False, None, 2, 2),
    (197, True, None, 4, 2),
    (256, True, 200, 4, 1),
    (256, False, 150, 2, 2),
])
def test_matches_the_reference_kernel(s, causal, kv_len, h, h_kv, dtype,
                                      kernel_parity):
    q, k, v, do = _qkv(2, s, h, h_kv, seed=s + h + h_kv)
    jd = jnp.dtype(dtype)
    want, vjp = jax.vjp(
        lambda q, k, v: jax_vmem(q, k, v, causal=causal, kv_len=kv_len),
        *(jnp.asarray(a, jd) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do, jd))

    td = getattr(torch, dtype)
    tq, tk, tv = (torch.tensor(a).to(td).requires_grad_() for a in (q, k, v))
    got = vmem_attention(tq, tk, tv, causal=causal, kv_len=kv_len)
    assert got.shape == (2, s, h, D) and got.dtype == td
    got_grads = torch.autograd.grad(got, (tq, tk, tv),
                                    torch.tensor(do).to(td))
    kernel_parity(got.detach().float().numpy(), np.asarray(want))
    for g, w in zip(got_grads, want_grads):
        assert g.dtype == td
        kernel_parity(g.float().numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
def test_matches_the_reference_kernel_at_wider_heads(d, dtype,
                                                      kernel_parity):
    """GPT-2's head dim and the widest the CUDA kernels take, causal with
    grouped K/V heads."""
    rng = np.random.Generator(np.random.PCG64(d))
    q, do = (rng.standard_normal((2, 128, 4, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((2, 128, 2, d)).astype(np.float32)
            for _ in range(2))
    jd = jnp.dtype(dtype)
    want, vjp = jax.vjp(lambda q, k, v: jax_vmem(q, k, v, causal=True),
                        *(jnp.asarray(a, jd) for a in (q, k, v)))
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.tensor(a).to(td).requires_grad_() for a in (q, k, v))
    got = vmem_attention(tq, tk, tv, causal=True)
    got_grads = torch.autograd.grad(got, (tq, tk, tv),
                                    torch.tensor(do).to(td))
    kernel_parity(got.detach().float().numpy(), np.asarray(want))
    for g, w in zip(got_grads, vjp(jnp.asarray(do, jd))):
        kernel_parity(g.float().numpy(), np.asarray(w))


@pytest.mark.parametrize("impl", ["auto", "vmem"])
def test_wrapper_errors_are_not_routed_around(monkeypatch, impl):
    """Only the reference's refusals (NotImplementedError) send auto or
    vmem elsewhere. Any other error of the kernel's wrapper (a head dim
    the CUDA kernels do not take, a tensor off the card, a failed build or
    launch) reaches the caller: nothing falls back to dense attention.
    Here the CUDA wrapper stands in for the CPU path and refuses the CPU
    tensors with ValueError."""
    monkeypatch.setattr(VA, "vmem_fwd", VA.vmem_fwd_cuda)
    q = torch.zeros(1, 128, 2, 200)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="CUDA"):
            multi_head_attention(q, q, q, causal=True, impl=impl)


def test_kv_len_equals_slicing_the_keys():
    """Keys at and past kv_len are inert: the output equals attention over
    the sliced keys, and their dk/dv are zero."""
    q, k, v, _ = _qkv(1, 128, 2, 2, seed=3)
    tq, tk, tv = (torch.tensor(a).requires_grad_() for a in (q, k, v))
    got = vmem_attention(tq, tk, tv, kv_len=100)
    want = dot_product_attention(tq, tk[:, :100], tv[:, :100])
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    dk, dv = torch.autograd.grad(got.sum(), (tk, tv))
    assert not dk[:, 100:].any() and not dv[:, 100:].any()


def test_lse_is_the_row_logsumexp():
    q, k, v, _ = _qkv(2, 64, 2, 2, seed=5)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    scale = VA._scale(D)
    o, lse = VA.vmem_fwd_plain(tq, tk, tv, causal=True, kv_len=64,
                               scale=scale)
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) * scale
    s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(), -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=2e-5,
                               atol=2e-5)
    assert o.shape == (2, 64, 2, D)


@pytest.mark.parametrize("s", [1025, 1100, 2048])
def test_refuses_sequences_past_max_seq(s):
    q = torch.zeros(1, s, 1, 8)
    with pytest.raises(NotImplementedError, match="S_pad"):
        vmem_attention(q, q, q, causal=True)


def test_refuses_what_the_reference_refuses():
    q, k = torch.zeros(1, 16, 3, 8), torch.zeros(1, 8, 2, 8)
    with pytest.raises(NotImplementedError, match="causal"):
        vmem_attention(q, torch.zeros(1, 8, 3, 8), torch.zeros(1, 8, 3, 8),
                       causal=True)
    with pytest.raises(NotImplementedError, match="multiple"):
        vmem_attention(q, k, k)
    with pytest.raises(NotImplementedError, match=r"\[B,S,H,D\]"):
        vmem_attention(q[0], q[0], q[0])


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = []
        real = VA.vmem_attention

        def spy(*a, **kw):
            self.calls.append(a[0].shape[1])
            return real(*a, **kw)

        monkeypatch.setattr(VA, "vmem_attention", spy)


@pytest.mark.parametrize("impl", ["auto", "vmem"])
def test_auto_routing(monkeypatch, impl):
    """auto / vmem: S_pad <= 1024 reaches the whole-row kernel; S 1025..2047
    goes to the dense path (vmem warns that it fell back); S >= 2048 goes
    to the blockwise flash kernel; a general mask forces the dense path."""
    spy = _Spy(monkeypatch)
    rng = np.random.Generator(np.random.PCG64(9))
    mk = lambda s: torch.tensor(rng.standard_normal((1, s, 2, 8)),
                                dtype=torch.float32)
    q = mk(197)
    got = multi_head_attention(q, q, q, causal=True, impl=impl)
    assert spy.calls == [197]
    torch.testing.assert_close(got, dot_product_attention(q, q, q, causal=True),
                               rtol=2e-5, atol=2e-5)
    q = mk(1100)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = multi_head_attention(q, q, q, causal=True, impl=impl)
    assert spy.calls == [197, 1100]  # tried, refused, dense
    assert any("unavailable" in str(w.message) for w in caught) == (
        impl == "vmem")
    torch.testing.assert_close(got, dot_product_attention(q, q, q, causal=True))
    q = mk(2048)
    flash = []
    real = FA.flash_attention
    monkeypatch.setattr(FA, "flash_attention",
                        lambda *a, **kw: flash.append(a[0].shape[1]) or
                        real(*a, **kw))
    got = multi_head_attention(q, q, q, causal=True, impl=impl)
    assert flash == [2048]
    torch.testing.assert_close(got, dot_product_attention(q, q, q, causal=True),
                               rtol=2e-5, atol=2e-5)
    q = mk(64)
    mask = torch.rand(1, 1, 64, 64, generator=torch.Generator().manual_seed(0)) > 0.3
    mask[..., 0] = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = multi_head_attention(q, q, q, mask=mask, impl=impl)
    assert spy.calls == [197, 1100, 2048]
    assert any("general mask" in str(w.message) for w in caught) == (
        impl == "vmem")
    torch.testing.assert_close(got, dot_product_attention(q, q, q, mask=mask))


@pytest.mark.parametrize("impl", ["auto", "vmem", "xla"])
def test_dispatch_matches_the_reference(impl, kernel_parity):
    """multi_head_attention on both sides, GQA and kv_len included."""
    q, k, v, _ = _qkv(2, 128, 4, 2, seed=11)
    want = jax_mha(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                   impl=impl, kv_len=96)
    got = multi_head_attention(*(torch.tensor(a) for a in (q, k, v)),
                               causal=True, impl=impl, kv_len=96)
    kernel_parity(got.numpy(), np.asarray(want))


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    seen = []
    monkeypatch.setattr(VA, "vmem_fwd_cuda", lambda *a, **k: seen.append("fwd"))
    monkeypatch.setattr(VA, "vmem_bwd_cuda", lambda *a, **k: seen.append("bwd"))
    card = types.SimpleNamespace(is_cuda=True)
    VA.vmem_fwd(card, None, None, causal=True, kv_len=1, scale=1.0)
    VA.vmem_bwd(card, None, None, None, None, None, causal=True, kv_len=1,
                scale=1.0)
    assert seen == ["fwd", "bwd"]
    monkeypatch.undo()
    VA.reset_launch_counts()
    q = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        VA.vmem_fwd_cuda(q, q, q, causal=True, kv_len=64, scale=0.125)
    vmem_attention(q.requires_grad_(), q, q, causal=True).sum().backward()
    assert set(VA.launch_counts.values()) == {0}


# -- the bf16 backward on the tensor cores ---------------------------------------
# The CUDA backward rounds p and ds to bf16 before their products, as the
# Pallas backward does, so they are single bf16 mma's with f32 sums
# (tests/torch_attention_model.py). Its arithmetic, modelled on the CPU,
# against the reference's VJP (_vmem_vjp_bwd in interpret mode from
# _vmem_fwd_raw's residuals), under lm_kernels_bench's element-wise bar:
# 2 bf16 ulps plus 2^-14 of the largest magnitude, beside the 2% rule.


@pytest.mark.parametrize("s,causal,kv_len,d,h_kv", [
    (256, True, None, 64, 2), (256, False, 200, 32, 4),
    (384, True, 300, 32, 1), (384, False, 250, 64, 4),
], ids=["S256-causal-D64-gqa", "S256-full-kv200-D32",
        "S384-causal-kv300-D32-mqa", "S384-full-kv250-D64"])
def test_mma_backward_model_matches_the_reference_vjp(s, causal, kv_len, d,
                                                      h_kv):
    rng = np.random.Generator(np.random.PCG64(s + d + h_kv))
    q, do = (rng.standard_normal((1, s, 4, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, s, h_kv, d)).astype(np.float32)
            for _ in range(2))
    sm_scale = 1.0 / float(np.sqrt(d))
    heads_first = lambda a: jnp.asarray(a, jnp.bfloat16).transpose(0, 2, 1, 3)
    jq, jk, jv, jdo = (heads_first(a) for a in (q, k, v, do))
    o, lse = _vmem_fwd_raw(jq, jk, jv, causal=causal, sm_scale=sm_scale,
                           kv_len=kv_len)
    want = _vmem_vjp_bwd(causal, sm_scale, kv_len, (jq, jk, jv, o, lse), jdo)
    bf = torch.bfloat16
    tq, tk, tv, tdo = (torch.tensor(a).to(bf) for a in (q, k, v, do))
    to = torch.tensor(np.asarray(o, np.float32).transpose(0, 2, 1, 3)).to(bf)
    got = mma_bwd_model(tq, tk, tv, to, tdo,
                        torch.tensor(np.asarray(lse, np.float32)[..., 0]),
                        causal=causal, kv_len=kv_len or s,
                        scale=VA._scale(d), parts=one_bf16)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.tensor(np.asarray(w, np.float32).transpose(0, 2, 1, 3)).to(bf)
        err, ok = LB.max_err(g, w)
        assert ok, f"{name}: {err:.3e}, {LB.elem_reading(g, w)}"


# -- the bf16 forward on the tensor cores ----------------------------------------
# The CUDA forward sums s = q k^T in f32 from bf16 products, takes the exact
# row max in a first pass, and rounds p = exp(s - m) to one bf16 for p v while
# l sums the f32 p (tests/torch_attention_model.py). Its arithmetic, modelled
# on the CPU with the score sums in XLA's order (so that only the rounding of
# p is under test), against _vmem_fwd_raw in interpret mode, under the
# element-wise bar. The same model with torch's own order of the sums is
# printed as a reading.


@pytest.mark.parametrize("s,causal,kv_len,d,h_kv", [
    (256, True, None, 64, 2), (300, False, 250, 20, 4),
    (384, True, 300, 64, 1), (200, True, None, 20, 2),
], ids=["S256-causal-D64-gqa", "S300-full-kv250-D20",
        "S384-causal-kv300-D64-mqa", "S200-causal-D20-gqa"])
def test_mma_forward_model_matches_the_pallas_kernel(s, causal, kv_len, d,
                                                     h_kv):
    rng = np.random.Generator(np.random.PCG64(s + d + h_kv + 7))
    q = rng.standard_normal((1, s, 4, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, s, h_kv, d)).astype(np.float32)
            for _ in range(2))
    pad = -s % 128
    heads_first = lambda a: jnp.pad(jnp.asarray(a, jnp.bfloat16), (
        (0, 0), (0, pad), (0, 0), (0, 0))).transpose(0, 2, 1, 3)
    o, lse = _vmem_fwd_raw(*(heads_first(a) for a in (q, k, v)),
                           causal=causal, sm_scale=1.0 / float(np.sqrt(d)),
                           kv_len=kv_len or s)
    bf = torch.bfloat16
    want_o = torch.tensor(np.asarray(o, np.float32).transpose(0, 2, 1, 3)
                          [:, :s]).to(bf)
    want_lse = torch.tensor(np.asarray(lse, np.float32)[:, :, :s, 0])
    tq, tk, tv = (torch.tensor(a).to(bf) for a in (q, k, v))
    kw = dict(causal=causal, kv_len=kv_len or s, scale=VA._scale(d))
    got_o, got_lse = mma_fwd_model(tq, tk, tv, dot=xla_dot(), **kw)
    own = mma_fwd_model(tq, tk, tv, dot=f32_dot, **kw)[0]
    print(f"o: {LB.elem_reading(got_o, want_o)}; with torch's order of the "
          f"score sums {LB.elem_reading(own, want_o)}")
    for name, g, w in (("o", got_o, want_o), ("lse", got_lse, want_lse)):
        err, ok = LB.max_err(g, w)
        assert ok, f"{name}: {err:.3e}"
