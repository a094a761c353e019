"""The port's GPT-2 (tpudist_torch.models.gpt2) against the JAX reference
on the same weights: the flax -> torch weight bridge, the dense forward,
decode-chunk logits in the scalar-cursor and per-row modes, and prefill
followed by single-token steps through the decode kernels' CPU path.
Tiny geometry (vocab 64, S 64, d 32, 2 layers, 4 heads), f32.

Tolerance: 2e-5 absolute on f32 logits — the two frameworks reduce in a
different order on the CPU (matmul blocking, softmax sums), which moves
f32 logits by a few ulp at this scale, never more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tpudist.generate import zero_cache as jax_zero_cache
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist_torch.generate import zero_cache
from tpudist_torch.interop import gpt2_params_from_flax
from tpudist_torch.models.gpt2 import GPT2

GEOM = dict(vocab_size=64, max_seq_len=64, hidden_dim=32, depth=2, num_heads=4)
ATOL = 2e-5


def _jax_model(attn_impl="xla"):
    return JGPT2(**GEOM, attn_impl=attn_impl)


def _flax_params(seed=0):
    params = _jax_model().init(
        jax.random.key(seed), np.zeros((1, 8), np.int32), train=False
    )["params"]
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


def _port_model(params, attn_impl="xla"):
    model = GPT2(**GEOM, attn_impl=attn_impl, device="cpu")
    model.load_state_dict(gpt2_params_from_flax(params))
    return model


def _tokens(shape, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, GEOM["vocab_size"], shape).astype(np.int32)


def test_params_from_flax_round_trip():
    """Every flax leaf lands in the port's state dict and reshapes back to
    itself exactly (DenseGeneral's grouped axes flattened, [in, out] ->
    [out, in])."""
    params = _flax_params(3)
    model = _port_model(params)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    d, h = GEOM["hidden_dim"], GEOM["num_heads"]
    np.testing.assert_array_equal(sd["wte"], params["wte"])
    np.testing.assert_array_equal(sd["wpe"], params["wpe"])
    for i in range(GEOM["depth"]):
        src = params[f"h_{i}"]
        np.testing.assert_array_equal(
            sd[f"h.{i}.qkv.weight"].T.reshape(d, 3, h, d // h),
            src["qkv"]["kernel"])
        np.testing.assert_array_equal(
            sd[f"h.{i}.qkv.bias"].reshape(3, h, d // h), src["qkv"]["bias"])
        np.testing.assert_array_equal(
            sd[f"h.{i}.out.weight"].T.reshape(h, d // h, d),
            src["out"]["kernel"])
        for name in ("mlp_fc", "mlp_proj"):
            np.testing.assert_array_equal(
                sd[f"h.{i}.{name}.weight"].T, src[name]["kernel"])
            np.testing.assert_array_equal(
                sd[f"h.{i}.{name}.bias"], src[name]["bias"])
        for ln in ("ln_1", "ln_2"):
            np.testing.assert_array_equal(sd[f"h.{i}.{ln}.scale"],
                                          src[ln]["scale"])
            np.testing.assert_array_equal(sd[f"h.{i}.{ln}.bias"],
                                          src[ln]["bias"])
    assert len(sd) == 4 + 12 * GEOM["depth"]


def test_dense_forward_matches_jax():
    params = _flax_params(1)
    toks = _tokens((2, 11), seed=1)
    want = _jax_model().apply({"params": params}, jnp.asarray(toks),
                              train=False)
    got = _port_model(params)(torch.from_numpy(toks).long()).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
def test_prefill_then_single_token_steps_match_jax(attn_impl):
    """Scalar-cursor decode: an 8-token prefill chunk (dense, causal within
    the chunk) then three single-token steps (with ``fused``, the
    contiguous decode kernel: Pallas in interpret mode on the JAX side,
    the plain version on the port's) — logits agree at every step."""
    params = _flax_params(2)
    jm = _jax_model(attn_impl)
    pm = _port_model(params, attn_impl)
    toks = _tokens((2, 11), seed=2)
    jcache = jax_zero_cache(jm, 2)
    pcache = zero_cache(pm, 2)
    chunks = [toks[:, :8], toks[:, 8:9], toks[:, 9:10], toks[:, 10:11]]
    for chunk in chunks:
        want, upd = jm.apply({"params": params, "cache": jcache},
                             jnp.asarray(chunk), train=False, decode=True,
                             mutable=["cache"])
        jcache = upd["cache"]
        got = pm(torch.from_numpy(chunk).long(), cache=pcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
    assert pcache["position"] == 11
    assert all(layer["index"] == 11 for layer in pcache["layers"])


def test_per_row_decode_chunk_matches_jax():
    """Per-row positions (the contiguous serving pool): rows at different
    cursors write and attend their own slots; a 3-token chunk is causal
    within the chunk per row."""
    params = _flax_params(4)
    jm, pm = _jax_model(), _port_model(params)
    jcache, pcache = jax_zero_cache(jm, 3), zero_cache(pm, 3)
    pos = np.array([0, 5, 20], np.int32)
    for step, s in enumerate((3, 1)):
        chunk = _tokens((3, s), seed=10 + step)
        want, upd = jm.apply({"params": params, "cache": jcache},
                             jnp.asarray(chunk), train=False, decode=True,
                             positions=jnp.asarray(pos), mutable=["cache"])
        jcache = upd["cache"]
        got = pm(torch.from_numpy(chunk).long(), cache=pcache,
                 positions=torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        pos = pos + s


def test_per_row_overrun_raises_and_poisons():
    """A row whose first entry is past max_seq_len fails loudly; a chunk
    whose TAIL pokes past it NaN-poisons just those entries."""
    pm = _port_model(_flax_params(0))
    cache = zero_cache(pm, 2)
    with pytest.raises(ValueError, match="max_seq_len"):
        pm(torch.zeros(2, 1, dtype=torch.long), cache=cache,
           positions=torch.tensor([3, 64], dtype=torch.int32))
    out = pm(torch.zeros(2, 3, dtype=torch.long), cache=cache,
             positions=torch.tensor([3, 62], dtype=torch.int32))
    assert torch.isfinite(out[0]).all() and torch.isfinite(out[1, :2]).all()
    assert torch.isnan(out[1, 2]).all()


def test_unported_attention_impls_raise():
    """Every attention kernel of the reference is ported: the whole-row
    kernel behind "vmem" and "auto", the blockwise one behind "flash";
    the context-parallel impls raise without the layout they run over
    (the reference's without its mesh; tests/test_torch_cp.py runs
    them)."""
    for impl in ("vmem", "auto", "flash"):
        assert GPT2(**GEOM, attn_impl=impl, device="cpu").attn_impl == impl
    with pytest.raises(ValueError, match="attn_impl"):
        GPT2(**GEOM, attn_impl="ring", device="cpu")


def test_random_init_follows_flax_distributions():
    """Seeded init draws flax's distributions: zero biases, unit LN
    scales, N(0, 0.02) wte, N(0, 0.01) wpe, lecun-normal kernels
    (std sqrt(1 / fan_in), truncated at 2 sigma) — and the same seed gives
    the same weights."""
    geom = dict(GEOM, vocab_size=4096, hidden_dim=64)
    a = GPT2(**geom, device="cpu", seed=7).requires_grad_(False)
    b = GPT2(**geom, device="cpu", seed=7).requires_grad_(False)
    for (ka, va), (_, vb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(va, vb), ka
    assert abs(float(a.wte.std()) - 0.02) < 1e-3
    assert abs(float(a.wpe.std()) - 0.01) < 1e-3
    blk = a.h[0]
    for lin, fan_in in ((blk.qkv, 64), (blk.mlp_proj, 256)):
        w = lin.weight
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.05
        assert float(w.abs().max()) <= 2.0 * (1.0 / fan_in) ** 0.5 / 0.8796 + 1e-6
        assert float(lin.bias.abs().max()) == 0.0
    assert float((blk.ln_1.scale - 1).abs().max()) == 0.0


def test_bf16_model_keeps_f32_logits_and_norms():
    """At bf16 the parameters are float32 masters cast to bf16 at each use
    (flax's per-use cast); the serving copy holds the matmul weights in
    bf16 and LayerNorm params in f32, and computes the same logits; the
    tied head returns f32 logits."""
    from tpudist_torch.models.gpt2 import compute_copy

    m = GPT2(**GEOM, dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.float32 for p in m.parameters())
    held = compute_copy(m)
    assert held.wte.dtype == torch.bfloat16
    assert held.h[0].qkv.weight.dtype == torch.bfloat16
    assert held.h[0].ln_1.scale.dtype == torch.float32
    assert compute_copy(held) is held and m.wte.dtype == torch.float32
    tokens = torch.zeros(1, 4, dtype=torch.long)
    out = m(tokens).detach()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert torch.equal(out, held(tokens).detach())
