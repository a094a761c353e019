"""The port's BERT (tpudist_torch.models.bert) against the JAX reference
(tpudist.models.bert) on the same weights, carried across by
``interop.bert_params_from_flax``, on the CPU.

A tiny encoder (vocab 300, d 64, 2 layers, 4 heads, S 64): the logits
and every parameter's gradient for each non-CP ``attn_impl`` (the
reference's Pallas kernels in interpret mode, the port's plain
versions), the fused LayerNorm path against the reference's
``FusedLayerNorm`` in interpret mode, the key-padding mask, the
``scan_layers`` (stacked) layout, the classifier and the graft of
pretrained weights into it, the MLM corruption's draws, and the MLM loss
full and chunked.

Tolerances (float32 on both sides, summed in other orders): logits under
the repo's kernel-parity rule (2e-5 absolute and relative); gradients
within 1e-4 relative plus 1e-6 absolute, as the GPT-2 flash test; the
corruption is held to equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tpudist.models import bert as J
from tpudist_torch.interop import bert_params_from_flax
from tpudist_torch.models import bert as T

GEOM = dict(vocab_size=300, max_seq_len=64, hidden_dim=64, depth=2,
            num_heads=4)
S = 64
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # pytest-xdist runs several workers on one host (tests/test_torch_train.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _init(model, seed=0, s=S):
    """The reference's params, its init under ``jax.jit`` (one compiled
    program instead of a dispatch per operation; the gradients below
    too)."""
    params = jax.jit(lambda: model.init(
        jax.random.key(seed), jnp.zeros((1, s), jnp.int32),
        train=False)["params"])()
    return _np_tree(params)


def _tokens(shape, seed=0, vocab=GEOM["vocab_size"]):
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, vocab, shape).astype(np.int32)


def _port(params, **kw):
    model = T.Bert(**{**GEOM, **kw}, device="cpu")
    model.load_state_dict(bert_params_from_flax(params))
    return model


def _against_reference(jm, pm, params, tokens, targets, kernel_parity,
                       **call):
    """Logits, and the gradients of the mean CE against ``targets``, on
    both sides."""
    import optax

    jcall = {k: jnp.asarray(v) for k, v in call.items()}

    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(tokens), train=False,
                          **jcall)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(targets)).mean(), logits

    (_, want), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want_grads = _np_tree(jg)
    pcall = {k: torch.from_numpy(v) for k, v in call.items()}
    got = pm(torch.from_numpy(tokens), **pcall)
    torch.nn.functional.cross_entropy(
        got.reshape(-1, got.shape[-1]),
        torch.from_numpy(targets).long().reshape(-1)).backward()
    kernel_parity(got.detach().numpy(), np.asarray(want))
    return want_grads


def _grads_close(pm, want_grads):
    for k, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def test_params_from_flax_cover_the_state_dict():
    """Every flax leaf lands on the port's state dict (names, shapes: the
    qkv bias keeps ``[3, heads, dh]``), and back to itself exactly."""
    params = _init(J.Bert(**GEOM), seed=1)
    pm = _port(params)
    sd = pm.state_dict()
    assert set(sd) == set(bert_params_from_flax(params))
    d, h = GEOM["hidden_dim"], GEOM["num_heads"]
    assert tuple(sd["h.0.qkv.bias"].shape) == (3, h, d // h)
    np.testing.assert_array_equal(
        sd["h.1.qkv.weight"].numpy().T.reshape(d, 3, h, d // h),
        params["h_1"]["qkv"]["kernel"])
    np.testing.assert_array_equal(
        sd["h.0.out.weight"].numpy().T.reshape(h, d // h, d),
        params["h_0"]["out"]["kernel"])
    np.testing.assert_array_equal(sd["mlm_head.bias"].numpy(),
                                  params["mlm_head"]["bias"])


@pytest.mark.parametrize("attn_impl", ["xla", "vmem", "flash", "auto"])
def test_logits_and_gradients_match_the_reference(attn_impl, kernel_parity):
    jm = J.Bert(**GEOM, attn_impl=attn_impl)
    params = _init(jm, seed=2)
    tokens = _tokens((2, S), seed=3)
    pm = _port(params, attn_impl=attn_impl)
    _grads_close(pm, bert_params_from_flax(_against_reference(
        jm, pm, params, tokens, _tokens((2, S), seed=4), kernel_parity)))


def test_fused_ln_matches_the_references_fused_layernorm(kernel_parity):
    """``fused_ln``: ``ln_embed`` through the kernel's plain composition,
    both post-LNs through its post-norm composition at eps 1e-12 (the
    reference's ``FusedLayerNorm`` in interpret mode)."""
    jm = J.Bert(**GEOM, fused_ln=True)
    params = _init(J.Bert(**GEOM), seed=5)
    tokens = _tokens((2, S), seed=6)
    pm = _port(params, fused_ln=True)
    _grads_close(pm, bert_params_from_flax(_against_reference(
        jm, pm, params, tokens, _tokens((2, S), seed=7), kernel_parity)))


def test_key_mask_path_matches_the_reference(kernel_parity):
    """An ``attention_mask`` (1 = real token) excludes the padded keys on
    the dense path, with types of both segments."""
    jm = J.Bert(**GEOM)
    params = _init(jm, seed=8)
    tokens = _tokens((2, S), seed=9)
    mask = np.ones((2, S), np.int32)
    mask[0, 40:] = 0
    mask[1, 9:] = 0
    types = np.zeros((2, S), np.int32)
    types[:, 20:] = 1
    pm = _port(params)
    _grads_close(pm, bert_params_from_flax(_against_reference(
        jm, pm, params, tokens, _tokens((2, S), seed=10), kernel_parity,
        attention_mask=mask, token_types=types)))


def test_padding_is_invisible_to_the_real_tokens():
    """The reference's padding test: a padded batch under its mask gives
    the real positions the logits of the unpadded one."""
    pm = T.Bert(**GEOM, device="cpu", seed=3)
    tokens = _tokens((2, 9), seed=11)
    base = pm(torch.from_numpy(tokens)).detach()
    padded = np.zeros((2, 16), np.int32)
    padded[:, :9] = tokens
    mask = np.zeros((2, 16), np.int32)
    mask[:, :9] = 1
    out = pm(torch.from_numpy(padded),
             attention_mask=torch.from_numpy(mask)).detach()
    np.testing.assert_allclose(out[:, :9].numpy(), base.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_scan_layers_stacked_layout(kernel_parity):
    """The reference's ``scan_layers`` tree (stacked under ``hs/block``)
    converts to the unrolled blocks: the port with ``scan_layers`` and
    ``remat_layers`` gives the scanned reference's logits and
    gradients, and equals the unrolled port bit for bit."""
    jm = J.Bert(**GEOM, scan_layers=True, remat_layers=True)
    params = _init(jm, seed=12)
    assert "hs" in params and params["hs"]["block"]["qkv"]["kernel"].shape[0] == 2
    tokens = _tokens((2, S), seed=13)
    pm = _port(params, scan_layers=True, remat_layers=True)
    _grads_close(pm, bert_params_from_flax(_against_reference(
        jm, pm, params, tokens, _tokens((2, S), seed=14), kernel_parity)))
    flat = _port(params)
    t = torch.from_numpy(tokens)
    assert torch.equal(flat(t), pm(t))
    with pytest.raises(ValueError, match="remat_layers requires scan_layers"):
        T.Bert(**GEOM, remat_layers=True, device="cpu")


def test_classifier_and_the_graft_match_the_reference(kernel_parity):
    """``BertClassifier`` (pooled first token, f32 head) on grafted
    pretrained weights: the port's graft of a ``Bert`` state dict equals
    the reference's ``classifier_params_from_mlm`` leaf for leaf, and the
    logits and gradients agree."""
    jc = J.BertClassifier(num_labels=3, **GEOM)
    fresh = _init(jc, seed=15)
    pretrained = _init(J.Bert(**GEOM), seed=16)
    want_params = _np_tree(J.classifier_params_from_mlm(fresh, pretrained))
    pc = T.BertClassifier(3, **GEOM, device="cpu")
    fresh_sd = {f"bert.{k}": v
                for k, v in bert_params_from_flax(fresh["bert"]).items()}
    for name in ("pooler", "classifier"):
        fresh_sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(fresh[name]["kernel"].T))
        fresh_sd[f"{name}.bias"] = torch.from_numpy(fresh[name]["bias"])
    grafted = T.classifier_params_from_mlm(
        fresh_sd, bert_params_from_flax(pretrained))
    for k, v in bert_params_from_flax(want_params["bert"]).items():
        assert torch.equal(grafted[f"bert.{k}"], v), k
    pc.load_state_dict(grafted)
    tokens = _tokens((4, 16), seed=17)
    jg = _against_reference(jc, pc, want_params, tokens,
                            _tokens((4,), seed=18, vocab=3), kernel_parity)
    np.testing.assert_allclose(pc.pooler.weight.grad.numpy(),
                               jg["pooler"]["kernel"].T, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(pc.classifier.bias.grad.numpy(),
                               jg["classifier"]["bias"], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    _grads_close(pc.bert, bert_params_from_flax(jg["bert"]))
    bad = dict(bert_params_from_flax(pretrained))
    bad.pop("h.1.ln_mlp.bias")
    with pytest.raises(ValueError, match="do not match"):
        T.classifier_params_from_mlm(fresh_sd, bad)


def test_mlm_transform_draws_as_the_reference():
    """The same seed gives the reference's corruption, batch after batch
    (one stream advancing per call)."""
    rng = np.random.Generator(np.random.PCG64(19))
    batches = [rng.integers(5, 290, (4, S)).astype(np.int32) for _ in range(3)]
    want = J.mlm_transform(300, 299, seed=7)
    got = T.mlm_transform(300, 299, seed=7)
    for tokens in batches:
        w, o = want({"tokens": tokens}), got({"tokens": tokens})
        assert set(w) == set(o)
        for k in w:
            np.testing.assert_array_equal(o[k], w[k], err_msg=k)


def test_mlm_random_replacement_never_injects_mask_id():
    """The reference's test (tests/test_bert.py): with every selected
    position sent to a random id, none is [MASK] and the others stay
    reachable."""
    rng = np.random.Generator(np.random.PCG64(24))
    tokens = rng.integers(0, 5, (512, 64)).astype(np.int32)
    tr = T.mlm_transform(vocab_size=5, mask_id=3, random_rate=1.0,
                         keep_rate=0.0, seed=0)
    out = tr({"tokens": tokens})
    sel = out["mlm_mask"]
    assert sel.sum() > 1000
    replaced = out["tokens"][sel]
    assert not (replaced == 3).any()
    assert set(np.unique(replaced)) == {0, 1, 2, 4}


@pytest.mark.parametrize("chunk", [None, 16], ids=["full", "chunked"])
def test_mlm_forward_matches_the_reference(chunk):
    """The masked-CE mean over the corrupted positions and its gradients,
    the full head and the chunked one (one process: the global count is
    the local one)."""
    jm = J.Bert(**GEOM)
    params = _init(jm, seed=20)
    batch = J.mlm_transform(300, 299, seed=3)({"tokens": _tokens((2, S), 21)})
    jloss = J.mlm_forward(jm, chunk=chunk)
    (want, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, {}, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(params)
    want_grads = bert_params_from_flax(_np_tree(jg))
    pm = _port(params)
    pm.train()
    got = T.mlm_forward(pm, chunk=chunk)(
        pm, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for k, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    with pytest.raises(ValueError, match="dropout"):
        T.mlm_forward(T.Bert(**GEOM, dropout=0.1, device="cpu"))


def test_cp_impls_need_a_layout_and_refuse_a_mask():
    with pytest.raises(ValueError, match="layout"):
        T.Bert(**GEOM, attn_impl="ring", device="cpu")
    from tpudist_torch.mesh import MeshConfig, create_layout

    pm = T.Bert(**GEOM, attn_impl="ring", device="cpu",
                layout=create_layout(MeshConfig(data=-1, seq=1)))
    tokens = torch.from_numpy(_tokens((1, 8), seed=22))
    with pytest.raises(ValueError, match="attention_mask"):
        pm(tokens, attention_mask=torch.ones(1, 8))
    # one seq rank: the ring makes one hop, the dense path's function
    dense = T.Bert(**GEOM, device="cpu")
    dense.load_state_dict(pm.state_dict())
    np.testing.assert_allclose(pm(tokens).detach().numpy(),
                               dense(tokens).detach().numpy(), rtol=2e-5,
                               atol=2e-5)
