"""The port's rematerialization (tpudist_torch.remat, GPT-2's per-block
``remat_policy`` / ``remat_layers`` / ``scan_layers``, and
``make_train_step(remat=...)``) against the JAX reference's contracts.

Remat is a pure memory/FLOP trade: under every policy, per block or over
the whole forward, a depth-2 width-64 GPT-2's loss and gradients are
bit-identical to the un-checkpointed ones, with dropout 0.1 as well (each
dropout site seeds its generator from its key at the call, so the
recompute draws the same masks). The stored-residual bytes (what the
backward keeps: the tensors autograd saves, counted through
``saved_tensors_hooks``, plus the products a selective policy caches)
order ``save_nothing <= full <= dots_saveable <= none``, strictly at the
ends, as the reference asserts on its saved residuals
(tests/test_sharded_optim.py). A scanned flax GPT-2 converts to the port
and computes the reference's logits under the f32 parity rule."""

import jax
import numpy as np
import pytest
import torch
from flax.core import meta
from torch.utils.checkpoint import CheckpointPolicy

from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.remat import POLICY_NAMES as JAX_POLICY_NAMES
from tpudist.remat import resolve as jax_resolve
from tpudist_torch import remat
from tpudist_torch.generate import generate
from tpudist_torch.interop import gpt2_params_from_flax
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.resnet import resnet18
from tpudist_torch.optim import make_optimizer
from tpudist_torch.train import (
    create_train_state, dropout_key, lm_loss, make_train_step,
)

GEOM = dict(vocab_size=64, max_seq_len=32, hidden_dim=64, depth=2,
            num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # several pytest-xdist workers share the host (tests/test_torch_train.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("policy", [*JAX_POLICY_NAMES, True, False, None,
                                    "dots", 3], ids=repr)
def test_resolve_is_the_references(policy):
    try:
        want = jax_resolve(policy)
    except ValueError as e:
        with pytest.raises(ValueError, match="unknown remat policy") as got:
            remat.resolve(policy)
        assert str(e).split(";")[0] == str(got.value).split(";")[0]
        return
    got = remat.resolve(policy)
    assert (got is None) == (want is None)
    if want is not None:
        # a selective policy exactly where the reference names one
        assert ("context_fn" in got) == ("policy" in want)
    assert remat.POLICY_NAMES == JAX_POLICY_NAMES


def _tokens(b=2, s=32, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return torch.from_numpy(rng.integers(0, GEOM["vocab_size"], (b, s)))


def _loss_and_grads(model, tokens, key):
    model.train()
    model.zero_grad(set_to_none=True)
    loss = lm_loss(model(tokens, dropout_key=key), tokens)
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in
                           model.named_parameters()}


@pytest.mark.parametrize("hook", ["per_block", "whole_forward"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("policy", ["full", "dots_saveable", "save_nothing"])
def test_remat_gradients_are_bit_identical(policy, rate, hook):
    tokens = _tokens()
    key = dropout_key(0, 0, 5)
    base = GPT2(**GEOM, dropout=rate, device="cpu")
    want_loss, want = _loss_and_grads(base, tokens, key)
    if hook == "per_block":
        model = GPT2(**GEOM, dropout=rate, remat_policy=policy, device="cpu")
    else:
        model = remat.remat_module(GPT2(**GEOM, dropout=rate, device="cpu"),
                                   policy)
    loss, grads = _loss_and_grads(model, tokens, key)
    assert torch.equal(loss, want_loss)
    for k in want:
        assert torch.equal(grads[k], want[k]), k
    if rate:
        # the masks are real: another key moves the loss
        other, _ = _loss_and_grads(model, tokens, dropout_key(0, 0, 6))
        assert not torch.equal(other, loss)


def _stored_bytes(policy) -> int:
    """The reference's residual-MLP probe (6 blocks, u = tanh(h w1),
    h + tanh(u w2), each block checkpointed under ``policy``): the bytes
    autograd saves plus the bytes a selective policy caches."""
    rng = np.random.Generator(np.random.PCG64(0))
    h = 64
    ws = [(torch.tensor(rng.standard_normal((h, 4 * h)) * 0.05,
                        dtype=torch.float32, requires_grad=True),
           torch.tensor(rng.standard_normal((4 * h, h)) * 0.05,
                        dtype=torch.float32, requires_grad=True))
          for _ in range(6)]
    x = torch.tensor(rng.standard_normal((32, h)), dtype=torch.float32)
    cached = []
    named = remat.resolve(policy)
    if named and "context_fn" in named:
        inner = {"dots_saveable": remat.dots_saveable,
                 "save_nothing": remat.nothing_saveable}[policy]

        def counted(ctx, op, *args, **kwargs):
            decision = inner(ctx, op, *args, **kwargs)
            if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                cached.append(ctx.op_output.numel()
                              * ctx.op_output.element_size())
            return decision

        policy = counted

    def block(hh, w1, w2):
        u = torch.tanh(hh @ w1)
        return hh + torch.tanh(u @ w2)

    lay = remat.checkpoint(block, policy)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        hh = x
        for w1, w2 in ws:
            hh = lay(hh, w1, w2)
        loss = (hh ** 2).mean()
    loss.backward()
    return sum(saved) + sum(cached)


def test_stored_bytes_follow_the_references_order():
    stored = {p: _stored_bytes(p) for p in remat.POLICY_NAMES}
    assert (stored["save_nothing"] <= stored["full"]
            <= stored["dots_saveable"] <= stored["none"]), stored
    assert (stored["save_nothing"] < stored["dots_saveable"]
            < stored["none"]), stored


def test_dots_saveable_saves_products_and_nothing_else():
    aten = torch.ops.aten
    for op in (aten.mm.default, aten.addmm.default, aten.bmm.default,
               aten.baddbmm.default, aten._scaled_mm.default):
        assert remat.dots_saveable(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (aten.empty.memory_format, aten.tanh.default, aten.rand.default,
               aten.add.Tensor):
        assert remat.dots_saveable(None, op) == CheckpointPolicy.PREFER_RECOMPUTE
        assert remat.nothing_saveable(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


def test_the_references_layout_rules():
    with pytest.raises(ValueError, match="remat_layers requires scan_layers"):
        GPT2(**GEOM, remat_layers=True, device="cpu")
    with pytest.raises(ValueError, match="unknown remat policy"):
        GPT2(**GEOM, remat_policy="dots", device="cpu")
    scanned = GPT2(**GEOM, scan_layers=True, remat_layers=True, device="cpu")
    assert scanned.block_policy == "full"
    with pytest.raises(ValueError, match="scan_layers has no decode path"):
        generate(scanned, np.zeros((1, 4), np.int32), 2, temperature=0.0)


def test_a_scanned_flax_gpt2_computes_the_references_logits():
    tokens = _tokens(seed=3).numpy().astype(np.int32)
    flags = dict(scan_layers=True, remat_layers=True)
    jm = JGPT2(**GEOM, **flags)
    params = jm.init(jax.random.key(1), tokens[:1, :8], train=False)
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    assert "hs" in params["params"]
    want = np.asarray(jm.apply(params, tokens, train=False))
    model = GPT2(**GEOM, **flags, device="cpu")
    model.load_state_dict(gpt2_params_from_flax(params))
    got = model(torch.from_numpy(tokens)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_whole_forward_remat_trains_bit_identically_with_dropout():
    """Two steps of make_train_step(remat=...) with dropout 0.1 and two
    accumulated microbatches: the losses and parameters of the plain run,
    bit for bit."""
    batch = {"tokens": _tokens(b=4, seed=5)}
    runs = []
    for policy in ("none", "full", "dots_saveable"):
        model = GPT2(**GEOM, dropout=0.1, device="cpu")
        tx = make_optimizer(1e-3, weight_decay=0.1)
        state = create_train_state(model, tx)
        step = make_train_step(model, tx, loss_fn=lm_loss, input_key="tokens",
                               label_key="tokens", grad_accum=2, remat=policy,
                               dropout_seed=11)
        losses = [float(step(state, batch)[1]["loss"]) for _ in range(2)]
        runs.append((losses, state.params()))
    (l0, p0), *rest = runs
    for losses, params in rest:
        assert losses == l0
        for k in p0:
            assert torch.equal(params[k], p0[k]), k


def test_remat_refuses_a_model_that_updates_buffers_in_its_forward():
    model = resnet18(num_filters=8, device="cpu")
    with pytest.raises(ValueError, match="running statistics"):
        make_train_step(model, make_optimizer(1e-3), remat="full")
