"""The card's bf16 tied-head backward (tpudist_torch.models.gpt2's
``tied_head_grads``, which ``_TiedHeadF32`` runs with ``torch.mm(...,
out_dtype=float32)``) against the reference's: ``jax.vjp`` of the
weight-tied head ``einsum("sd,vd->sv", x, wte,
preferred_element_type=f32)`` (tpudist/models/gpt2.py) on bf16 ``x [256,
768]`` and ``wte [4001, 768]`` with an f32 logits cotangent, the same
numpy inputs on both sides. ``torch.mm`` with ``out_dtype`` does not run
on the CPU, so ``mm`` here multiplies the bf16 values in f32: every
product of two bf16 values is exact in f32 and the sums are f32, as on
the tensor cores.

A cotangent rounded to one bf16 misses the reference by about one bf16
ulp, which an element bar of 2 ulps does not see. So the test reads the
share of bf16 gradient elements that differ from JAX's (at most 1%; the
rest of the share is the order of the f32 sums) and the f32 sums before
the cast (within 2^-15 of the largest magnitude of an f64 product). The
old rounding of ``g`` to one bf16 is held to the same checks and must
miss them, so the fault it was stays shown."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist_torch.models.gpt2 import tied_head_grads
from torch_threads import two_torch_threads  # noqa: F401

N, V, DIM = 256, 4001, 768
#: the checks: share of bf16 elements that differ from JAX, and the f32
#: sums' distance from an f64 product relative to its largest magnitude
MAX_SHARE = 0.01
MAX_REL = 2.0 ** -15


def one_bf16_grads(g, x2, wte, mm):
    """The old backward: ``g`` rounded to the operands' dtype first."""
    gb = g.to(x2.dtype)
    return mm(gb, wte), mm(gb.t(), x2)


def _f32_mm(a, b):
    return a.float() @ b.float()


@pytest.mark.parametrize("grads,holds", [(tied_head_grads, True),
                                         (one_bf16_grads, False)],
                         ids=["hi+lo", "one-bf16"])
def test_head_backward_against_the_reference_vjp(grads, holds):
    rng = np.random.Generator(np.random.PCG64(0))
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    wte = (0.02 * rng.standard_normal((V, DIM))).astype(np.float32)
    g = (rng.standard_normal((N, V)) / (N * 40)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wte, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b: jnp.einsum(
        "sd,vd->sv", a, b, preferred_element_type=jnp.float32), jx, jw)
    want = [torch.tensor(np.asarray(t, np.float32))
            for t in vjp(jnp.asarray(g))]
    tx, tw, tg = (torch.tensor(x).bfloat16(), torch.tensor(wte).bfloat16(),
                  torch.tensor(g))
    exact = (tg.double() @ tw.double(), tg.double().t() @ tx.double())
    sums = grads(tg, tx, tw, _f32_mm)
    for name, s32, s64, w in zip(("dx", "dwte"), sums, exact, want):
        assert s32.dtype == torch.float32 and s32.shape == w.shape
        share = float((s32.bfloat16().float() != w).float().mean())
        rel = float((s32.double() - s64).abs().max() / s64.abs().max())
        print(f"{name}: {share:.4%} of bf16 elements differ from JAX; f32 "
              f"sums within {rel:.3e} of the f64 product's largest")
        assert (share <= MAX_SHARE and rel <= MAX_REL) == holds, (share, rel)
        if not holds:
            assert share > 10 * MAX_SHARE and rel > 10 * MAX_REL, (share, rel)


def test_the_head_casts_its_gradients_once(monkeypatch):
    """``_TiedHeadF32.backward`` rounds :func:`tied_head_grads`' f32 sums
    once to the operands' dtype (its products run on the card only; here
    ``torch.mm`` is stood in for by f32 products of the bf16 values)."""
    from tpudist_torch.models import gpt2

    rng = np.random.Generator(np.random.PCG64(1))
    x2 = torch.tensor(rng.standard_normal((64, 32)), dtype=torch.bfloat16)
    wte = torch.tensor(rng.standard_normal((101, 32)), dtype=torch.bfloat16)
    g = torch.tensor(rng.standard_normal((64, 101)), dtype=torch.float32)
    ctx = type("Ctx", (), {"saved_tensors": (x2, wte)})()
    monkeypatch.setattr(gpt2, "_mm_f32", _f32_mm)
    dx, dwte = gpt2._TiedHeadF32.backward(ctx, g)
    want = tied_head_grads(g, x2, wte, _f32_mm)
    assert dx.dtype == dwte.dtype == torch.bfloat16
    assert torch.equal(dx, want[0].bfloat16())
    assert torch.equal(dwte, want[1].bfloat16())
