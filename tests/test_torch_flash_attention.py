"""The port's blockwise flash attention (tpudist_torch.ops.flash_attention)
against the JAX reference (tpudist.ops.flash_attention) on the same numpy
inputs: S 128, 256, a ragged 300, and 384 with ``kv_len`` 250; causal and
not; head dims 32 and 64; float32 and bfloat16. Held against (a) the
Pallas ``_flash_fwd`` in interpret mode (o and lse), (b) the Pallas
``_bwd_pallas`` in interpret mode from the same residuals (dq, dk, dv),
(c) ``jax.vjp(flash_attention)`` end to end, whose backward on the CPU is
the blockwise scan ``_bwd_blockwise``, and (d) ``multi_head_attention``'s
routing: ``impl="flash"``, ``auto`` from S 2048, a general mask and causal
``s_q != s_k`` to the dense path with a warning, and no other error
routed around. Then (e) the bf16 backward's tensor-core arithmetic, p and
ds carried as hi + lo bf16 pairs (``tests/torch_attention_model.py``),
against ``_bwd_pallas``, and (f) the bf16 forward's, p rounded to one bf16
against the running max of each 128-key tile, against ``_flash_fwd``,
both under ``lm_kernels_bench``'s element-wise bar; a 64-key running max
misses the forward's function.

Tolerance: the repo's kernel-parity rule (``kernel_parity``): 2e-5
absolute and relative in float32; in bfloat16 2% of the reference's
largest magnitude (p is rounded to bf16 against the running max on both
sides, and the sums run in different orders).

On the CPU the wrappers take the kernels' plain versions; the kernels are
held to those on the card by ``chip_smoke.py`` (phase 16)."""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.ops.attention import multi_head_attention as jax_mha
from tpudist.ops.flash_attention import _bwd_pallas, _flash_fwd
from tpudist.ops.flash_attention import flash_attention as jax_flash
from torch_attention_model import (f32_dot, mma_bwd_model, mma_fwd_model,
                                   one_bf16, split_bf16, xla_dot)
from tpudist_torch.ops import flash_attention as FA
from tpudist_torch.ops import lm_kernels_bench as LB
from tpudist_torch.ops import vmem_attention as VA
from tpudist_torch.ops.attention import dot_product_attention, multi_head_attention
from tpudist_torch.ops.flash_attention import flash_attention
from torch_threads import two_torch_threads  # noqa: F401

CASES = [
    (128, True, None, 32), (128, False, None, 64),
    (256, True, None, 64), (256, False, None, 32),
    (300, True, None, 32), (300, False, None, 64),
    (384, True, 250, 64), (384, False, 250, 32),
]
IDS = [f"S{s}-{'causal' if c else 'full'}-kv{kv}-D{d}" for s, c, kv, d in CASES]


def _inputs(b, s, h, d, seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32)
                 for _ in range(4))


def _jax_forward(q, k, v, *, causal, kv_len, dtype):
    """The reference wrapper's padding around ``_flash_fwd`` (S to 128, D
    to 128, ``kv_len`` masking the padded keys), returning the padded
    residuals and the unpadded ``(o, lse)``."""
    b, s, h, d = q.shape
    pad_s, pad_d = -s % 128, -d % 128
    jd = jnp.dtype(dtype)
    padded = [jnp.pad(jnp.asarray(a, jd), ((0, 0), (0, pad_s), (0, 0),
                                           (0, pad_d))).transpose(0, 2, 1, 3)
              for a in (q, k, v)]
    kv = s if kv_len is None else kv_len
    eff_kv = None if kv == s + pad_s else kv
    o, lse = _flash_fwd(*padded, causal=causal, sm_scale=1.0 / float(np.sqrt(d)),
                        block_q=128, block_k=128, kv_len=eff_kv)
    res = (*padded, o, lse)
    return res, eff_kv, o.transpose(0, 2, 1, 3)[:, :s, :, :d], lse[:, :, :s]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,causal,kv_len,d", CASES, ids=IDS)
def test_forward_matches_the_pallas_kernel(s, causal, kv_len, d, dtype,
                                           kernel_parity):
    q, k, v, _ = _inputs(1, s, 2, d, seed=s + d)
    _, _, want_o, want_lse = _jax_forward(q, k, v, causal=causal,
                                          kv_len=kv_len, dtype=dtype)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.tensor(a).to(td) for a in (q, k, v))
    o, lse = FA.flash_fwd_plain(tq, tk, tv, causal=causal,
                                kv_len=kv_len or s, scale=VA._scale(d))
    assert o.shape == (1, s, 2, d) and o.dtype == td
    assert lse.shape == (1, 2, s) and lse.dtype == torch.float32
    kernel_parity(o.float().numpy(), np.asarray(want_o))
    kernel_parity(lse.numpy(), np.asarray(want_lse))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,causal,kv_len,d", CASES, ids=IDS)
def test_backward_matches_the_pallas_kernels(s, causal, kv_len, d, dtype,
                                             kernel_parity):
    """From the reference's own residuals (q, k, v, o, lse), the plain
    backward against ``_bwd_pallas`` in interpret mode."""
    q, k, v, do = _inputs(1, s, 2, d, seed=s + d + 1)
    res, eff_kv, o, lse = _jax_forward(q, k, v, causal=causal, kv_len=kv_len,
                                       dtype=dtype)
    jd = jnp.dtype(dtype)
    g = jnp.pad(jnp.asarray(do, jd), ((0, 0), (0, -s % 128), (0, 0),
                                      (0, -d % 128))).transpose(0, 2, 1, 3)
    want = _bwd_pallas(res, g, causal=causal, sm_scale=1.0 / float(np.sqrt(d)),
                       block_q=128, block_k=128, kv_len=eff_kv, interpret=True)
    td = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.tensor(a).to(td) for a in (q, k, v, do))
    to = torch.tensor(np.asarray(o, np.float32)).to(td)
    got = FA.flash_bwd_plain(tq, tk, tv, to, tdo,
                             torch.tensor(np.asarray(lse)), causal=causal,
                             kv_len=kv_len or s, scale=VA._scale(d))
    for g_, w in zip(got, want):
        assert g_.dtype == td
        w = np.asarray(w).transpose(0, 2, 1, 3)[:, :s, :, :d]
        kernel_parity(g_.float().numpy(), w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,causal,kv_len,d", CASES, ids=IDS)
def test_autograd_matches_the_reference_vjp(s, causal, kv_len, d, dtype,
                                            kernel_parity):
    """flash_attention and its gradients against ``jax.vjp`` of the
    reference's wrapper (forward in interpret mode, ``_bwd_blockwise``)."""
    q, k, v, do = _inputs(2, s, 2, d, seed=s + d + 2)
    jd = jnp.dtype(dtype)
    want, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal=causal, kv_len=kv_len),
        *(jnp.asarray(a, jd) for a in (q, k, v)))
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.tensor(a).to(td).requires_grad_() for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, kv_len=kv_len)
    assert got.shape == (2, s, 2, d) and got.dtype == td
    got_grads = torch.autograd.grad(got, (tq, tk, tv), torch.tensor(do).to(td))
    kernel_parity(got.detach().float().numpy(), np.asarray(want))
    for g, w in zip(got_grads, vjp(jnp.asarray(do, jd))):
        assert g.dtype == td
        kernel_parity(g.float().numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wider_key_blocks_match_the_reference(dtype, kernel_parity):
    """The plain version honours any block_k that tiles S (another bf16
    function: the running max moves once per block), as the reference's."""
    q, k, v, _ = _inputs(1, 512, 2, 32, seed=21)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax_flash(*(jnp.asarray(a, jd) for a in (q, k, v)), causal=True,
                     block_k=256)
    got = flash_attention(*(torch.tensor(a).to(td) for a in (q, k, v)),
                          causal=True, block_k=256)
    kernel_parity(got.float().numpy(), np.asarray(want))


def test_kv_len_equals_slicing_the_keys():
    """Keys at and past kv_len are inert: the output equals attention over
    the sliced keys, and their dk/dv are zero."""
    q, k, v, _ = _inputs(1, 256, 2, 32, seed=3)
    tq, tk, tv = (torch.tensor(a).requires_grad_() for a in (q, k, v))
    got = flash_attention(tq, tk, tv, kv_len=130)
    want = dot_product_attention(tq, tk[:, :130], tv[:, :130])
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    dk, dv = torch.autograd.grad(got.sum(), (tk, tv))
    assert not dk[:, 130:].any() and not dv[:, 130:].any()


def test_refuses_what_the_reference_refuses():
    q = torch.zeros(1, 256, 2, 8)
    with pytest.raises(NotImplementedError, match="causal"):
        flash_attention(q, q[:, :128], q[:, :128], causal=True)
    with pytest.raises(NotImplementedError, match="128-aligned"):
        flash_attention(q, q, q, block_k=192)
    with pytest.raises(NotImplementedError, match="128-aligned"):
        q3 = torch.zeros(1, 384, 2, 8)  # 256-row blocks do not tile 384
        flash_attention(q3, q3, q3, block_q=256)
    with pytest.raises(NotImplementedError, match=r"\[B,S,H,D\]"):
        flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="heads"):
        flash_attention(q, q[:, :, :1], q[:, :, :1])


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = []
        real = FA.flash_attention

        def spy(*a, **kw):
            self.calls.append(a[0].shape[1])
            return real(*a, **kw)

        monkeypatch.setattr(FA, "flash_attention", spy)


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_routing(monkeypatch, impl):
    """flash: every length reaches the blockwise kernel; auto: from S 2048
    (below it the whole-row kernel or the dense path). A general mask and
    causal attention with s_q != s_k go dense with a warning; grouped K/V
    heads are repeated before the kernel."""
    spy = _Spy(monkeypatch)
    rng = np.random.Generator(np.random.PCG64(9))
    mk = lambda s, h=2: torch.tensor(rng.standard_normal((1, s, h, 8)),
                                     dtype=torch.float32)
    q = mk(197)
    got = multi_head_attention(q, q, q, causal=True, impl=impl)
    assert spy.calls == ([197] if impl == "flash" else [])
    torch.testing.assert_close(got, dot_product_attention(q, q, q, causal=True),
                               rtol=2e-5, atol=2e-5)
    q, kv = mk(2048, 4), mk(2048, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = multi_head_attention(q, kv, kv, causal=True, impl=impl)
    assert spy.calls[-1] == 2048
    kk = torch.repeat_interleave(kv, 2, dim=2)
    torch.testing.assert_close(
        got, dot_product_attention(q, kk, kk, causal=True), rtol=2e-5,
        atol=2e-5)
    n = len(spy.calls)
    q = mk(64)
    mask = torch.rand(1, 1, 64, 64, generator=torch.Generator().manual_seed(0)) > 0.3
    mask[..., 0] = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = multi_head_attention(q, q, q, mask=mask, impl=impl)
    assert len(spy.calls) == n
    assert any("general mask" in str(w.message) for w in caught) == (
        impl == "flash")
    torch.testing.assert_close(got, dot_product_attention(q, q, q, mask=mask))
    if impl == "flash":
        k = mk(32)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = multi_head_attention(q, k, k, causal=True, impl=impl)
        assert spy.calls[-1] == 64  # tried, refused, dense
        assert any("unavailable" in str(w.message) for w in caught)
        torch.testing.assert_close(
            got, dot_product_attention(q, k, k, causal=True))


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_wrapper_errors_are_not_routed_around(monkeypatch, impl):
    """Only the reference's refusals (NotImplementedError) send flash
    elsewhere. Any other error of the kernel's wrapper (a head dim the
    CUDA kernels do not take, a tensor off the card, a failed build or
    launch) reaches the caller: nothing falls back to dense attention.
    Here the CUDA wrapper stands in for the CPU path and refuses the CPU
    tensors with ValueError."""
    monkeypatch.setattr(FA, "flash_fwd", FA.flash_fwd_cuda)
    q = torch.zeros(1, 2048, 2, 200)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="CUDA"):
            multi_head_attention(q, q, q, causal=True, impl=impl)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_dispatch_matches_the_reference(impl, kernel_parity):
    """multi_head_attention on both sides, GQA and kv_len included."""
    q, k, v, _ = _inputs(2, 256, 4, 16, seed=11)
    k, v = k[:, :, :2], v[:, :, :2]
    want = jax_mha(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                   impl=impl, kv_len=200)
    got = multi_head_attention(*(torch.tensor(a) for a in (q, k, v)),
                               causal=True, impl=impl, kv_len=200)
    kernel_parity(got.numpy(), np.asarray(want))


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    seen = []
    monkeypatch.setattr(FA, "flash_fwd_cuda", lambda *a, **k: seen.append("fwd"))
    monkeypatch.setattr(FA, "flash_bwd_cuda", lambda *a, **k: seen.append("bwd"))
    card = types.SimpleNamespace(is_cuda=True)
    FA.flash_fwd(card, None, None, causal=True, kv_len=1, scale=1.0)
    FA.flash_bwd(card, None, None, None, None, None, causal=True, kv_len=1,
                 scale=1.0)
    assert seen == ["fwd", "bwd"]
    monkeypatch.undo()
    FA.reset_launch_counts()
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_fwd_cuda(q, q, q, causal=True, kv_len=128, scale=0.125)
    flash_attention(q.requires_grad_(), q, q, causal=True).sum().backward()
    assert set(FA.launch_counts.values()) == {0}


def test_the_kernel_takes_only_its_key_tile():
    """The CUDA forward updates the running max once per 128 keys; another
    block_k is another bf16 function, which it refuses rather than
    computing the wrong one."""
    q = torch.zeros(1, 256, 2, 64)
    with pytest.raises(ValueError, match="block_k"):
        FA.flash_fwd_cuda(q, q, q, causal=True, kv_len=256, scale=0.125,
                          block_k=256)


# -- the bf16 backward on the tensor cores ---------------------------------------
# The CUDA backward carries the f32 p and ds of the flash function into its
# bf16 products as hi + lo pairs (tests/torch_attention_model.py). Its
# arithmetic, modelled on the CPU, against the Pallas backward in interpret
# mode, under lm_kernels_bench's element-wise bar: 2 bf16 ulps plus 2^-14 of
# the largest magnitude, beside the 2% rule.

#: S 256 and 384, D 64 and 32, causal and kv_len < S
MMA_CASES = [
    (256, True, None, 64), (256, False, 200, 32),
    (384, True, 300, 32), (384, False, 250, 64),
]
MMA_IDS = [f"S{s}-{'causal' if c else 'full'}-kv{kv}-D{d}"
           for s, c, kv, d in MMA_CASES]


def test_split_bf16_carries_an_f32_value():
    """hi + lo stands for x within 2^-16 relative, where hi alone is off
    by up to 2^-9."""
    rng = np.random.Generator(np.random.PCG64(5))
    x = torch.tensor(rng.standard_normal(100_000).astype(np.float32)
                     * np.exp2(rng.integers(-30, 30, 100_000)).astype(np.float32))
    hi, lo = split_bf16(x)
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    rel = ((hi + lo - x).abs() / x.abs()).max().item()
    assert rel <= 2.0 ** -16, rel
    assert ((hi - x).abs() / x.abs()).max().item() > 2.0 ** -10


@pytest.mark.parametrize("s,causal,kv_len,d", MMA_CASES, ids=MMA_IDS)
def test_mma_backward_model_matches_the_pallas_kernels(s, causal, kv_len, d):
    """The hi + lo model from the reference's own residuals against
    ``_bwd_pallas`` in interpret mode, in bf16. The model with p and ds
    rounded to one bf16 (vmem's function) is printed as a reading."""
    q, k, v, do = _inputs(1, s, 2, d, seed=s + d + 3)
    res, eff_kv, o, lse = _jax_forward(q, k, v, causal=causal, kv_len=kv_len,
                                       dtype="bfloat16")
    g = jnp.pad(jnp.asarray(do, jnp.bfloat16),
                ((0, 0), (0, -s % 128), (0, 0), (0, -d % 128))
                ).transpose(0, 2, 1, 3)
    want = _bwd_pallas(res, g, causal=causal, sm_scale=1.0 / float(np.sqrt(d)),
                       block_q=128, block_k=128, kv_len=eff_kv, interpret=True)
    bf = torch.bfloat16
    tq, tk, tv, tdo = (torch.tensor(a).to(bf) for a in (q, k, v, do))
    to = torch.tensor(np.asarray(o, np.float32)).to(bf)
    kw = dict(causal=causal, kv_len=kv_len or s, scale=VA._scale(d))
    args = (tq, tk, tv, to, tdo, torch.tensor(np.asarray(lse)))
    got = mma_bwd_model(*args, parts=split_bf16, **kw)
    single = mma_bwd_model(*args, parts=one_bf16, **kw)
    for name, g_, one, w in zip(("dq", "dk", "dv"), got, single, want):
        w = torch.tensor(np.asarray(w, np.float32).transpose(0, 2, 1, 3)
                         [:, :s, :, :d]).to(bf)
        err, ok = LB.max_err(g_, w)
        print(f"{name}: hi + lo {err:.3e} ({LB.elem_reading(g_, w)}); one "
              f"bf16 {LB.max_err(one, w)[0]:.3e} ({LB.elem_reading(one, w)})")
        assert ok, f"{name}: {err:.3e}, {LB.elem_reading(g_, w)}"


# -- the bf16 forward on the tensor cores ----------------------------------------
# The CUDA forward walks the Pallas kernel's 128-key tiles from key 0, takes
# the row max over all 128 keys before any exp, rounds p = exp(s - m_new) to
# one bf16 for p v, and sums l over the f32 p (tests/torch_attention_model.py).
# Its arithmetic, modelled on the CPU with the score sums in XLA's order (so
# that only the rounding of p is under test), against _flash_fwd in interpret
# mode, under the element-wise bar; the model with torch's own order of the
# sums is printed as a reading. A running max taken every 64 keys rounds p
# against other maxima: that misses the kernel's function, and the last test
# pins the 128-key unit by showing it.

FWD_CASES = [(256, True, None, 64), (300, False, 250, 20),
             (384, True, 300, 64), (200, True, None, 20)]
FWD_IDS = [f"S{s}-{'causal' if c else 'full'}-kv{kv}-D{d}"
           for s, c, kv, d in FWD_CASES]


def _mma_forward(s, causal, kv_len, d, block_k):
    """``((o, lse) of the model, (o, lse) of _flash_fwd)`` in bf16 / f32
    on one seeded input, and the model's ``o`` with torch's order."""
    q, k, v, _ = _inputs(1, s, 4, d, seed=s + d + 5)
    _, _, want_o, want_lse = _jax_forward(q, k, v, causal=causal,
                                          kv_len=kv_len, dtype="bfloat16")
    bf = torch.bfloat16
    want = (torch.tensor(np.asarray(want_o, np.float32)).to(bf),
            torch.tensor(np.asarray(want_lse, np.float32)))
    tq, tk, tv = (torch.tensor(a).to(bf) for a in (q, k, v))
    kw = dict(causal=causal, kv_len=kv_len or s, scale=VA._scale(d),
              block_k=block_k)
    got = mma_fwd_model(tq, tk, tv, dot=xla_dot(-d % 128), **kw)
    return got, want, mma_fwd_model(tq, tk, tv, dot=f32_dot, **kw)[0]


@pytest.mark.parametrize("s,causal,kv_len,d", FWD_CASES, ids=FWD_IDS)
def test_mma_forward_model_matches_the_pallas_kernel(s, causal, kv_len, d):
    got, want, own = _mma_forward(s, causal, kv_len, d, block_k=128)
    print(f"o: {LB.elem_reading(got[0], want[0])}; with torch's order of "
          f"the score sums {LB.elem_reading(own, want[0])}")
    for name, g, w in zip(("o", "lse"), got, want):
        err, ok = LB.max_err(g, w)
        assert ok, f"{name}: {err:.3e}"


@pytest.mark.parametrize("s,causal,kv_len,d", FWD_CASES[:2], ids=FWD_IDS[:2])
def test_a_64_key_running_max_misses_the_forward(s, causal, kv_len, d):
    """The same model stepping its running max every 64 keys (the CUDA
    forward's product tile) rounds p against other maxima: o misses the
    Pallas kernel's element-wise bar, by far more than any order of the
    sums moves it."""
    got, want, _ = _mma_forward(s, causal, kv_len, d, block_k=64)
    err, ok = LB.max_err(got[0], want[0])
    differ = float((got[0].float() != want[0].float()).float().mean())
    print(f"o with a 64-key running max: {err:.3e}, "
          f"{LB.elem_reading(got[0], want[0])}, {differ:.2%} of elements "
          f"differ")
    assert not ok and differ > 0.05
