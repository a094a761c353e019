"""The port's chunked LM loss (tpudist_torch.models.lm_utils) against the
JAX reference's (tpudist.models.lm_utils): ``chunked_lm_forward`` on a
tiny GPT-2 (2 layers, d 64, 2 heads, byte vocab) carried over from flax
params by ``gpt2_params_from_flax``, loss and every parameter's gradient,
at chunks 1, 7 and 256 with S - 1 = 39 positions (7 and 256 pad the last
chunk), in float32 and, at chunk 7, bfloat16; the chunked loss equal to
``lm_loss`` on the full logits; the trainer's ``forward_loss`` composing
with ``grad_accum`` and ``fused="ln"`` for two steps against the
reference's; and the refusals.

Tolerance. float32: losses within 2e-6 relative, gradients within 1e-5
relative plus 1e-7 absolute (the frameworks sum the CE over chunks, the
vocabulary and the two uses of ``wte`` in different orders; nothing is
rounded below float32). bfloat16: the repo's bf16 rule against the
largest magnitude (``kernel_parity``): 2% for the loss, and for the
gradients, which run every product in bf16. Trainer: losses within 1e-5
relative and parameters within 1e-4 relative plus 1e-4 absolute after
two AdamW steps, the qkv key slice held to its step bound, as in
tests/test_torch_gpt2_train.py."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tpudist import mesh as mesh_lib
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.models.lm_utils import chunked_lm_forward as jax_chunked
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.optim import run_schedule as jax_run_schedule
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import lm_loss as jax_lm_loss
from tpudist.train import make_train_step as jax_make_train_step
from tpudist_torch.interop import gpt2_params_from_flax
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.lm_utils import chunked_lm_forward
from tpudist_torch.optim import make_optimizer, run_schedule
from tpudist_torch.train import create_train_state, lm_loss, make_train_step

GEOM = dict(vocab_size=256, max_seq_len=64, hidden_dim=64, depth=2,
            num_heads=2)
S = 40


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # pytest-xdist runs several workers on one host (tests/test_torch_train.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _tokens(b=2, s=S, seed=3):
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, GEOM["vocab_size"], (b, s)).astype(np.int32)


def _pair(dtype, seed=0):
    jm = JGPT2(**GEOM, dtype=jnp.dtype(dtype))
    params = jm.init(jax.random.key(seed), np.zeros((1, 8), np.int32),
                     train=False)["params"]
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    model = GPT2(**GEOM, dtype=getattr(torch, dtype), device="cpu")
    model.load_state_dict(gpt2_params_from_flax(params))
    return jm, params, model


@pytest.mark.parametrize("chunk,dtype", [
    (1, "float32"), (7, "float32"), (256, "float32"), (7, "bfloat16"),
])
def test_loss_and_gradients_match_the_reference(chunk, dtype, kernel_parity):
    jm, params, model = _pair(dtype)
    batch = {"tokens": _tokens()}
    fl = jax_chunked(jm, chunk=chunk)
    want, want_grads = jax.value_and_grad(
        lambda p: fl(p, None, batch)[0])(params)
    want_grads = gpt2_params_from_flax(
        jax.tree_util.tree_map(np.asarray, want_grads))

    loss = chunked_lm_forward(model, chunk=chunk)(
        model, {"tokens": torch.from_numpy(batch["tokens"])})
    assert loss.dtype == torch.float32 and loss.ndim == 0
    loss.backward()
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    assert got_grads.keys() == want_grads.keys()
    if dtype == "float32":
        np.testing.assert_allclose(loss.item(), float(want), rtol=2e-6)
        for k, w in want_grads.items():
            np.testing.assert_allclose(got_grads[k].numpy(), w.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    else:
        kernel_parity(np.float32(loss.item()),
                      np.asarray(want, jnp.bfloat16))
        for k, w in want_grads.items():
            kernel_parity(got_grads[k].numpy(),
                          w.numpy().astype(jnp.bfloat16))


@pytest.mark.parametrize("chunk", [5, 63, 64])
def test_equals_lm_loss_on_full_logits(chunk):
    """The same function as the full-logits loss, padded chunk or not,
    gradients included."""
    torch.manual_seed(0)
    model = GPT2(**GEOM, device="cpu", seed=1)
    tokens = torch.from_numpy(_tokens(s=64, seed=4))
    got = chunked_lm_forward(model, chunk=chunk)(model, {"tokens": tokens})
    g_got = torch.autograd.grad(got, list(model.parameters()))
    want = lm_loss(model(tokens), tokens)
    g_want = torch.autograd.grad(want, list(model.parameters()))
    torch.testing.assert_close(got, want, rtol=2e-6, atol=0)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("fused,grad_accum", [(None, 2), ("ln", 1)],
                         ids=["grad-accum-2", "fused-ln"])
def test_trainer_forward_loss_matches_the_reference(fused, grad_accum):
    """make_train_step(forward_loss=chunked_lm_forward(...)) on both sides:
    the loss replaces loss_fn for every microbatch, and under fused="ln"
    the port's loss sees the model's fused_ln attribute (the reference
    rebuilds its loss over a fused clone)."""
    steps, batch = 2, 2
    rng = np.random.Generator(np.random.PCG64(7))
    batches = [{"tokens": rng.integers(0, 256, (batch * grad_accum, S))
                .astype(np.int32)} for _ in range(steps)]
    mesh = mesh_lib.create_mesh(devices=jax.devices()[:1])
    jm = JGPT2(**GEOM)
    opt_kw = dict(weight_decay=0.1, clip_norm=1.0)
    jtx = jax_make_optimizer(
        jax_run_schedule(1e-3, total_steps=steps, warmup_steps=1), **opt_kw)
    jstate = jax_create_train_state(jm, 0, jnp.zeros((1, S), jnp.int32), jtx,
                                    mesh)
    init = gpt2_params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(jstate.params)))
    jstep = jax_make_train_step(
        jm, jtx, mesh, loss_fn=jax_lm_loss, input_key="tokens",
        label_key="tokens", fused=fused, grad_accum=grad_accum,
        forward_loss=jax_chunked(jm, chunk=16))
    want_losses = []
    for b in batches:
        jstate, metrics = jstep(jstate, b)
        want_losses.append(float(metrics["loss"]))

    model = GPT2(**GEOM, device="cpu")
    model.load_state_dict(init)
    tx = make_optimizer(run_schedule(1e-3, total_steps=steps, warmup_steps=1),
                        **opt_kw)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, loss_fn=lm_loss, input_key="tokens",
                           label_key="tokens", fused=fused,
                           grad_accum=grad_accum,
                           forward_loss=chunked_lm_forward(model, chunk=16))
    assert model.fused_ln == (fused == "ln")
    losses = [float(step(state, {"tokens": torch.from_numpy(b["tokens"])})[1]
                    ["loss"]) for b in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = gpt2_params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(jstate.params)))
    got = state.params()
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        if k.endswith("qkv.bias"):
            for side in (g[1], w[1]):
                assert np.abs(side - init[k].numpy()[1]).max() <= \
                    1.5 * steps * 1e-3, k
            g, w = g[[0, 2]], w[[0, 2]]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=k)


def test_refusals():
    model = GPT2(**GEOM, device="cpu")
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        chunked_lm_forward(model, chunk=0)
    with pytest.raises(ValueError, match="dropout"):
        chunked_lm_forward(types.SimpleNamespace(dropout=0.1), chunk=8)
