"""The port's Llama decode path against the JAX reference on the same
weights (``interop.llama_params_from_flax``), GQA 4/2, depth 2, width 32,
S 64, float32 on the CPU: decode-chunk logits with the scalar cursor and
with per-row positions (keys rotated at their absolute positions before
they are cached, q at the same offset), the cache sized by the K/V heads,
greedy ``generate()`` against ``tpudist.generate.generate`` through the
dense path and the contiguous kernel's CPU path, and the paged engine's
greedy streams against the reference's paged engine (mirroring
tests/test_serve_paged.py's llama case) and against the port's own
``generate()``, with a prefix-cache hit resuming the prefill at its true
offset.

Tolerance: 2e-5 absolute on float32 logits (tests/test_torch_gpt2.py);
greedy token streams are held exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tpudist.generate import generate as jax_generate
from tpudist.generate import zero_cache as jax_zero_cache
from tpudist.models.llama import Llama as JLlama
from tpudist.serve import ServeEngine as JServeEngine
from tpudist_torch.generate import generate, zero_cache
from tpudist_torch.interop import llama_params_from_flax
from tpudist_torch.models.llama import Llama
from tpudist_torch.serve import ServeEngine
from tpudist_torch.serve.blocks import paged_cache

GEOM = dict(vocab_size=64, max_seq_len=64, hidden_dim=32, depth=2,
            num_heads=4, num_kv_heads=2, ffn_dim=64)
ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _flax_params(seed):
    params = JLlama(**GEOM).init(
        jax.random.key(seed), np.zeros((1, 8), np.int32), train=False
    )["params"]
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


def _converted(params, attn_impl="xla"):
    m = Llama(**GEOM, attn_impl=attn_impl, device="cpu")
    m.load_state_dict(llama_params_from_flax(params))
    return m


def _prompts(lens, vocab=64, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [rng.integers(0, vocab, (p,)).astype(np.int32) for p in lens]


def _pool_clean(engine):
    pool = engine.pool.blocks
    held = np.nonzero(pool.refcount > 0)[0]
    cached = (set() if engine.pool.prefix is None else
              {e.block for e in engine.pool.prefix._entries.values()})
    assert set(held.tolist()) == cached
    assert all(pool.refcount[b] == 1 for b in cached)


def test_cache_holds_the_kv_heads():
    """The contiguous and paged caches hold H_kv heads (the reference's
    cache shapes), and no wpe cursor; a cache with H heads is refused."""
    params = _flax_params(0)
    model = _converted(params)
    cache = zero_cache(model, 3)
    jcache = jax_zero_cache(JLlama(**GEOM), 3)
    jk = jcache["layer_0"]["cached_key"]
    assert tuple(cache["layers"][0]["k"].shape) == (3, 2, 64, 8)
    assert jk.shape == (3, 2, 64, 8)  # the reference's, head-major too
    assert "position" not in cache and len(cache["layers"]) == 2
    assert tuple(paged_cache(model, 5, 8)["layers"][1]["v"].shape) == (5, 2, 8, 8)
    wrong = {"layers": [{"k": torch.zeros(1, 4, 64, 8),
                         "v": torch.zeros(1, 4, 64, 8), "index": 0}] * 2}
    with pytest.raises(ValueError, match="num_kv_heads"):
        model(torch.zeros(1, 1, dtype=torch.long), cache=wrong)


@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
def test_prefill_then_single_token_steps_match_jax(attn_impl):
    """Scalar cursor: an 8-token prefill chunk then three single-token
    steps (``fused``: the contiguous kernel, Pallas in interpret mode on
    the JAX side and the plain version here, reading grouped heads in
    place): the logits agree at every step."""
    params = _flax_params(2)
    jm = JLlama(**GEOM, attn_impl=attn_impl)
    pm = _converted(params, attn_impl)
    toks = np.stack(_prompts([11, 11], seed=2))
    jcache, pcache = jax_zero_cache(jm, 2), zero_cache(pm, 2)
    for chunk in (toks[:, :8], toks[:, 8:9], toks[:, 9:10], toks[:, 10:11]):
        want, upd = jm.apply({"params": params, "cache": jcache},
                             jnp.asarray(chunk), train=False, decode=True,
                             mutable=["cache"])
        jcache = upd["cache"]
        got = pm(torch.from_numpy(chunk).long(), cache=pcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
    assert all(layer["index"] == 11 for layer in pcache["layers"])


def test_per_row_decode_chunk_matches_jax():
    """Per-row positions (the contiguous serving pool): each row rotates
    and writes at its own cursor; a 3-token chunk is causal within the
    chunk per row."""
    params = _flax_params(4)
    jm, pm = JLlama(**GEOM), _converted(params)
    jcache, pcache = jax_zero_cache(jm, 3), zero_cache(pm, 3)
    pos = np.array([0, 5, 20], np.int32)
    for step, s in enumerate((3, 1)):
        chunk = np.stack(_prompts([s] * 3, seed=10 + step))
        want, upd = jm.apply({"params": params, "cache": jcache},
                             jnp.asarray(chunk), train=False, decode=True,
                             positions=jnp.asarray(pos), mutable=["cache"])
        jcache = upd["cache"]
        got = pm(torch.from_numpy(chunk).long(), cache=pcache,
                 positions=torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        pos = pos + s


@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
def test_greedy_generate_matches_jax(attn_impl):
    params = _flax_params(1)
    prompts = np.stack(_prompts([6, 6, 6], seed=1))
    want = jax_generate(JLlama(**GEOM, attn_impl=attn_impl), params, prompts,
                        10, temperature=0.0)
    got = generate(_converted(params, attn_impl), prompts, 10,
                   temperature=0.0)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_paged_engine_greedy_matches_the_reference_engine():
    """Mirrors tests/test_serve_paged.py's llama case on both sides: mixed
    prompt lengths crossing block boundaries, per-request stop tokens and
    staggered arrivals, the paged kernel (Pallas in interpret mode / the
    port's plain version) over grouped heads and per-row RoPE: every
    stream equals the reference engine's, and the port's own
    ``generate()`` truncated at its returned length."""
    params = _flax_params(2)
    prompts = _prompts([3, 6, 5, 9, 12, 17], seed=3)
    eos = 7
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    def drive(eng):
        rids = [eng.submit(prompts[i], 12, eos_id=eos) for i in range(3)]
        for _ in range(2):
            eng.step()
        rids += [eng.submit(prompts[i], 12, eos_id=eos) for i in (3, 4, 5)]
        out = eng.run()
        return [out[r] for r in rids]

    jout = drive(JServeEngine(JLlama(**GEOM, attn_impl="fused"), jparams,
                              max_slots=3, seed=0, paged=True, block_size=8,
                              watermark_blocks=2))
    model = _converted(params, "fused")
    peng = ServeEngine(model, max_slots=3, seed=0, paged=True, block_size=8,
                       watermark_blocks=2)
    pout = drive(peng)
    assert pout == jout
    for i, pr in enumerate(prompts):
        toks, lens = generate(model, pr[None], 12, temperature=0.0,
                              eos_id=eos, return_lengths=True)
        assert pout[i] == toks[0, : lens[0]].tolist(), i
    _pool_clean(peng)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_matches_generate_and_resumes_a_prefix_hit(paged):
    """The contiguous and the paged engine equal ``generate()`` under slot
    pressure; on the paged engine two requests sharing a 24-token system
    prompt resume the second's prefill after the cached blocks, at its true
    offset (the keys rotate at their absolute positions), and still equal
    a cold ``generate()``."""
    model = _converted(_flax_params(1), "fused")
    system = _prompts([24], seed=9)[0]
    prompts = [np.concatenate([system, t]) for t in _prompts([4, 7, 2, 9],
                                                             seed=11)]
    cold = [generate(model, p[None], 8, temperature=0.0)[0].tolist()
            for p in prompts]
    kw = dict(paged=True, block_size=8, watermark_blocks=2) if paged else {}
    eng = ServeEngine(model, max_slots=2, seed=0, **kw)
    r0 = eng.submit(prompts[0], 8)
    out = eng.run()
    rids = [eng.submit(p, 8) for p in prompts[1:]]
    out.update(eng.run())
    assert [out[r] for r in [r0, *rids]] == cold
    if paged:
        assert eng.stats.prefix_hit_rate > 0
        _pool_clean(eng)
