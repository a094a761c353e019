"""The port's T5 (tpudist_torch.models.t5, generate.generate_seq2seq)
against the JAX reference (tpudist.models.t5, tpudist.generate) on the
same weights, carried across by ``interop.t5_params_from_flax``, on the
CPU.

A tiny encoder-decoder (vocab 128, d 64, ffn 128, 2 + 2 layers; 4 heads,
and 6 heads whose ``d // h`` of 10 leaves an inner width of 60, t5_small's
geometry in miniature): the relative-position buckets, the logits and
every gradient, the incremental decode against the full forward, the
decode overrun, the span corruption bit for bit with its (seed, epoch,
start) keying through the loader and its resume, greedy
``generate_seq2seq``, and the seq2seq loss.

Tolerances (float32 on both sides, summed in other orders): logits under
the repo's kernel-parity rule (2e-5 absolute and relative), gradients
within 1e-4 relative plus 1e-6 absolute, the incremental decode within
the reference's own 2e-4 of the full forward; buckets, corruption and
greedy tokens are held to equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta

from tpudist.data.lm import TokenWindowLoader as JTokenWindowLoader
from tpudist.generate import generate_seq2seq as jax_generate_seq2seq
from tpudist.models import t5 as J
from tpudist_torch.data.lm import TokenWindowLoader
from tpudist_torch.generate import generate_seq2seq
from tpudist_torch.interop import t5_params_from_flax
from tpudist_torch.models import t5 as T

CFG = dict(vocab_size=128, hidden_dim=64, ffn_dim=128, enc_depth=2,
           dec_depth=2, num_heads=4, max_decode_len=16)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _ints(shape, seed, lo=1, hi=100):
    return np.random.Generator(np.random.PCG64(seed)).integers(
        lo, hi, shape).astype(np.int32)


def _pair(cfg, seed, enc, dec):
    """The reference model, its params and the port's model on them. The
    reference's init (and below, its gradients) run under ``jax.jit``: one
    compiled program instead of a dispatch per operation (eagerly the
    init alone took ~19 s of the CPU here)."""
    jm = J.T5(**cfg)
    init = jax.jit(lambda e, d: jm.init(jax.random.key(seed), (e, d),
                                        train=False)["params"])
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(
        init(jnp.asarray(enc), jnp.asarray(dec))))
    pm = T.T5(**cfg, device="cpu")
    pm.load_state_dict(t5_params_from_flax(params))
    return jm, params, pm


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bidirectional", "causal"])
def test_relative_position_buckets_equal_the_references(bidirectional):
    for q, k, buckets, dist in ((1, 1, 32, 128), (7, 12, 32, 128),
                                (64, 64, 32, 128), (300, 310, 32, 128),
                                (513, 513, 32, 128), (100, 90, 16, 64)):
        want = np.asarray(J.relative_position_buckets(
            q, k, bidirectional=bidirectional, num_buckets=buckets,
            max_distance=dist))
        got = T.relative_position_buckets(
            q, k, bidirectional=bidirectional, num_buckets=buckets,
            max_distance=dist).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{q}x{k}")


@pytest.mark.parametrize("heads", [4, 6])
def test_logits_and_gradients_match_the_reference(heads, kernel_parity):
    cfg = dict(CFG, num_heads=heads)
    enc, dec = _ints((2, 24), 0), _ints((2, 10), 1)
    tgt = _ints((2, 10), 2, 0, 128)
    jm, params, pm = _pair(cfg, 3, enc, dec)

    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(enc), jnp.asarray(dec),
                          train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(tgt)).mean(), logits

    (_, want), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want_grads = t5_params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(jg)))
    got = pm(torch.from_numpy(enc), torch.from_numpy(dec))
    torch.nn.functional.cross_entropy(
        got.reshape(-1, got.shape[-1]),
        torch.from_numpy(tgt).long().reshape(-1)).backward()
    kernel_parity(got.detach().numpy(), np.asarray(want))
    assert pm.enc[0].attn.q.weight.shape == (heads * (64 // heads), 64)
    for k, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def test_incremental_decode_matches_the_full_forward():
    """The reference's test: step by step through the cache, then a
    5-token chunk and one step, against the reference's teacher-forced
    logits; the encoder output against ``encode_only``'s."""
    enc, dec = _ints((2, 12), 4, 1, 40), _ints((2, 8), 5, 1, 40)
    jm, params, pm = _pair(CFG, 0, enc, dec)
    full = np.asarray(jax.jit(lambda p: jm.apply(
        {"params": p}, enc, dec, train=False))(params))
    want_enc = np.asarray(jax.jit(lambda p: jm.apply(
        {"params": p}, enc, train=False, encode_only=True))(params))
    e = pm(torch.from_numpy(enc), encode_only=True)
    np.testing.assert_allclose(e.detach().numpy(), want_enc, rtol=2e-5,
                               atol=2e-5)
    cache = pm.init_cache(2)
    steps = [pm(torch.from_numpy(dec[:, t:t + 1]), decode=True, enc=e,
                cache=cache)[:, 0].numpy() for t in range(8)]
    np.testing.assert_allclose(np.stack(steps, 1), full, atol=2e-4, rtol=2e-4)
    assert cache["position"] == 8
    cache = pm.init_cache(2)
    chunk = pm(torch.from_numpy(dec[:, :5]), decode=True, enc=e, cache=cache)
    np.testing.assert_allclose(chunk.numpy(), full[:, :5], atol=2e-4,
                               rtol=2e-4)
    one = pm(torch.from_numpy(dec[:, 5:6]), decode=True, enc=e, cache=cache)
    np.testing.assert_allclose(one[:, 0].numpy(), full[:, 5], atol=2e-4,
                               rtol=2e-4)


def test_decode_overrun_fails_loudly():
    """A chunk longer than the cache, and the step past its last slot,
    raise naming max_decode_len (the reference's eager behaviour)."""
    pm = T.T5(**dict(CFG, max_decode_len=4), device="cpu")
    e = pm(torch.from_numpy(_ints((2, 6), 6, 1, 40)), encode_only=True)
    with pytest.raises(ValueError, match="max_decode_len"):
        pm(torch.ones(2, 5, dtype=torch.long), decode=True, enc=e,
           cache=pm.init_cache(2))
    cache = pm.init_cache(2)
    tok = torch.ones(2, 1, dtype=torch.long)
    for _ in range(4):
        assert torch.isfinite(pm(tok, decode=True, enc=e, cache=cache)).all()
    with pytest.raises(ValueError, match="max_decode_len"):
        pm(tok, decode=True, enc=e, cache=cache)


def _toy_batch():
    return {"tokens": _ints((4, 32), 7, 0, 40)}


def test_span_corruption_is_the_references_bit_for_bit():
    """Keyed by (seed, epoch, start), and by the batch's crc32 without a
    position: every output array equal to the reference's."""
    want, got = J.span_corrupt_transform(64, seed=3), \
        T.span_corrupt_transform(64, seed=3)
    assert got.wants_position
    batch = _toy_batch()
    for args in ((0, 0), (1, 0), (0, 4), (7, 96), ()):
        w, o = want(batch, *args), got(batch, *args)
        assert set(w) == set(o) == {"enc_tokens", "dec_tokens", "targets"}
        for k in w:
            np.testing.assert_array_equal(o[k], w[k], err_msg=f"{args} {k}")
    assert T.span_corruption_plan(512) == J.span_corruption_plan(512)


def test_span_corruption_fresh_per_epoch_and_exact_on_resume():
    """Through the port's loader: two epochs corrupt the same windows
    differently; ``iter_from`` replays the uninterrupted epoch's batches
    exactly; and every batch equals the reference loader's."""
    stream = np.arange(400, dtype=np.int32) % 40
    tr = T.span_corrupt_transform(64, seed=3)
    loader = TokenWindowLoader(stream, 4, 32, vocab_size=40, transform=tr,
                               seed=5)
    jloader = JTokenWindowLoader(stream, 4, 32, vocab_size=40, seed=5,
                                 transform=J.span_corrupt_transform(64, seed=3))
    runs = []
    for epoch in (0, 1):
        loader.sampler.set_epoch(epoch)
        jloader.sampler.set_epoch(epoch)
        batches = list(loader)
        for b, w in zip(batches, jloader):
            for k in w:
                np.testing.assert_array_equal(b[k], w[k])
        runs.append(batches)
        resumed = list(loader.iter_from(2))
        for b, w in zip(resumed, batches[2:]):
            for k in w:
                np.testing.assert_array_equal(b[k], w[k])
    assert not np.array_equal(runs[0][0]["enc_tokens"],
                              runs[1][0]["enc_tokens"])


def test_generate_seq2seq_greedy_matches_the_reference():
    """Greedy ``generate_seq2seq`` equals the reference's, and the
    full-forward greedy rollout (the reference's test); EOS retirement
    pads after the first EOS; too many tokens for the cache raise."""
    enc = _ints((2, 10), 8, 1, 40)
    jm, params, pm = _pair(CFG, 1, enc, np.zeros((2, 4), np.int32))
    want = jax_generate_seq2seq(jm, params, enc, 6, temperature=0.0)
    out = generate_seq2seq(pm, enc, 6, temperature=0.0)
    np.testing.assert_array_equal(out, want)
    assert out.shape == (2, 6) and out.dtype == np.int32
    dec = np.zeros((2, 1), np.int32)
    for _ in range(6):
        logits = pm(torch.from_numpy(enc), torch.from_numpy(dec))
        nxt = logits[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
        dec = np.concatenate([dec, nxt], axis=1)
    np.testing.assert_array_equal(out, dec[:, 1:])
    eos = int(out[0, 2])
    got, lengths = generate_seq2seq(pm, enc, 6, temperature=0.0, eos_id=eos,
                                    pad_id=0, return_lengths=True)
    want, want_len = jax_generate_seq2seq(jm, params, enc, 6, temperature=0.0,
                                          eos_id=eos, pad_id=0,
                                          return_lengths=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lengths, want_len)
    with pytest.raises(ValueError, match="max_decode_len"):
        generate_seq2seq(pm, enc, 16)


def test_seq2seq_forward_matches_the_reference():
    """The training loss on a corrupted batch and its gradients."""
    batch = J.span_corrupt_transform(128, seed=1)(
        {"tokens": _ints((2, 40), 9, 0, 100)}, 0, 0)
    jm, params, pm = _pair(CFG, 2, batch["enc_tokens"], batch["dec_tokens"])
    (want, _), jg = jax.jit(jax.value_and_grad(
        J.seq2seq_forward(jm), has_aux=True))(
            params, {}, {k: jnp.asarray(v) for k, v in batch.items()})
    want_grads = t5_params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(jg)))
    pm.train()
    got = T.seq2seq_forward(pm)(
        pm, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for k, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
