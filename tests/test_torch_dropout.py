"""Dropout in the port's GPT-2 and ViT against the reference's placement
and stream contract.

The reference drops on each residual branch before its add
(``tpudist/models/gpt2.py:69``, ``vit.py:61``) and, in GPT-2, on the
embedding sum (``gpt2.py:356``), keyed per step by ``fold_in(seed,
step)`` and per microbatch. JAX's bits cannot be reproduced, so the port
is held to the contract: at rate 0, and in eval mode at any rate, the
forward is bit-identical to the dropout-free one; in train mode it equals
the dropout-free forward with the drawn masks applied by hand at exactly
those places (forward hooks on a twin with the same weights); the kept
share lies within 4 sigma of 1 - p; keys differ across steps,
microbatches and ranks, and one key repeats its masks. The fused paths
without an rng stream refuse dropout, as the reference's do."""

import numpy as np
import pytest
import torch

from tpudist_torch.data.lm import TokenWindowLoader
from tpudist_torch.models.gpt2 import GPT2, dropout, site_key
from tpudist_torch.models.lm_utils import chunked_lm_forward
from tpudist_torch.models.vit import vit_b16
from tpudist_torch.optim import make_optimizer
from tpudist_torch.train import (
    create_train_state, dropout_key, fit, lm_loss, make_train_step,
)

RATE = 0.1


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # several pytest-xdist workers share the host (tests/test_torch_train.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _gpt2(rate):
    return GPT2(vocab_size=64, max_seq_len=16, hidden_dim=32, depth=2,
                num_heads=4, dropout=rate, device="cpu").train()


def _vit(rate):
    return vit_b16(num_classes=10, patch_size=8, hidden_dim=32, depth=2,
                   num_heads=4, mlp_dim=64, image_size=16, dropout=rate,
                   device="cpu").train()


def _inputs(kind):
    rng = np.random.Generator(np.random.PCG64(1))
    if kind == "gpt2":
        return torch.from_numpy(rng.integers(0, 64, (2, 16)))
    return torch.from_numpy(rng.random((2, 16, 16, 3)).astype(np.float32))


MODELS = {"gpt2": _gpt2, "vit": _vit}


@pytest.mark.parametrize("kind", ["gpt2", "vit"])
def test_rate_zero_and_eval_mode_are_the_dropout_free_forward(kind):
    x = _inputs(kind)
    key = dropout_key(0, 0, 3)
    with torch.no_grad():
        want = MODELS[kind](0.0)(x)
        assert torch.equal(MODELS[kind](0.0)(x, dropout_key=key), want)
        assert torch.equal(MODELS[kind](0.5).eval()(x, dropout_key=key), want)
        assert not torch.equal(MODELS[kind](0.5)(x, dropout_key=key), want)
    with pytest.raises(ValueError, match="needs a dropout_key"):
        MODELS[kind](0.5)(x)


def _hand_masks(model, kind, key, rate):
    """Forward hooks that apply ``dropout``'s masks to the outputs the
    reference drops (and, for GPT-2, to the embedding sum entering block
    0), each under its site's key."""
    blocks = model.h if kind == "gpt2" else model.blocks
    first = 1 if kind == "gpt2" else 0
    for i, blk in enumerate(blocks):
        bkey = site_key(key, i + first)
        branches = (blk.out, blk.mlp_proj) if kind == "gpt2" else (blk.out,
                                                                   blk.mlp)
        for site, mod in enumerate(branches):
            mod.register_forward_hook(
                lambda m, a, out, k=site_key(bkey, site):
                    dropout(out, rate, k))
    if kind == "gpt2":
        blocks[0].register_forward_pre_hook(
            lambda m, args: (dropout(args[0], rate, site_key(key, 0)),
                             *args[1:]))


@pytest.mark.parametrize("kind", ["gpt2", "vit"])
def test_train_mode_is_the_masks_applied_by_hand(kind):
    x = _inputs(kind)
    key = dropout_key(7, 1, 4)
    model = MODELS[kind](RATE)
    twin = MODELS[kind](0.0)
    twin.load_state_dict(model.state_dict())
    _hand_masks(twin, kind, key, RATE)
    with torch.no_grad():
        got = model(x, dropout_key=key)
        want = twin(x)
    assert torch.equal(got, want)
    with torch.no_grad():
        assert not torch.equal(model(x, dropout_key=key + 1), want)


def test_the_kept_share_and_the_scale():
    n = 200_000
    for dtype in (torch.float32, torch.bfloat16):
        out = dropout(torch.ones(n, dtype=dtype), RATE, dropout_key(0, 0, 0))
        kept = out != 0
        share = float(kept.float().mean())
        assert abs(share - (1 - RATE)) <= 4 * np.sqrt(RATE * (1 - RATE) / n)
        assert torch.equal(out[kept], torch.full_like(out[kept], 1.0) / (1 - RATE))


def test_keys_part_steps_ranks_and_sites_and_repeat():
    ones = torch.ones(4096)
    keys = {(r, i): dropout_key(5, r, i) for r in range(3) for i in range(4)}
    assert len(set(keys.values())) == len(keys)
    masks = {k: dropout(ones, RATE, v) != 0 for k, v in keys.items()}
    assert all(not torch.equal(masks[(0, 0)], m) for k, m in masks.items()
               if k != (0, 0))
    assert torch.equal(dropout(ones, RATE, keys[(1, 2)]) != 0, masks[(1, 2)])
    assert site_key(keys[(0, 0)], 1) != site_key(keys[(0, 0)], 2)
    assert site_key(None, 1) is None


def test_the_step_passes_a_fresh_key_to_every_microbatch():
    model = _gpt2(RATE)
    seen = []
    model.register_forward_pre_hook(
        lambda m, args, kwargs: seen.append(kwargs["dropout_key"]),
        with_kwargs=True)
    tx = make_optimizer(1e-3)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, loss_fn=lm_loss, input_key="tokens",
                           label_key="tokens", grad_accum=2, dropout_seed=9)
    batch = {"tokens": _inputs("gpt2").repeat(2, 1)}
    for _ in range(2):
        step(state, batch)
    assert seen == [dropout_key(9, 0, i) for i in range(4)]


def test_the_paths_without_a_stream_refuse_dropout(tmp_path):
    model = _gpt2(RATE)
    with pytest.raises(ValueError, match="does not support dropout"):
        chunked_lm_forward(model, chunk=8)
    loader = TokenWindowLoader(np.arange(200, dtype=np.int32) % 64, 2, 16)
    with pytest.raises(ValueError, match="forward_loss has no rng stream"):
        fit(model, make_optimizer(1e-3), loader, epochs=1, input_key="tokens",
            label_key="tokens", loss_fn=lm_loss, profile=False,
            forward_loss=lambda module, batch: module(batch["tokens"]).sum(),
            log_dir=str(tmp_path))
