"""The port's sgd, lamb, lion and muon (tpudist_torch.optim) against the
reference's ``make_optimizer`` (optax) on the same inputs.

- Three steps on a dict holding a 1-D bias, a 2-D Dense, a 4-D conv, a
  qkv ``[D, 3, H, dh]`` and an out ``[H, dh, D]`` kernel under flax names
  (the port's leaves carry the port's names and layouts: weights
  ``[out, in]``, conv OIHW), with and without ``weight_decay`` and
  ``clip_norm``, and with a cosine schedule. Tolerance 1e-6 absolute on
  parameters of magnitude ~1 after three steps of lr 1e-2: the
  element-wise optimizers round as optax does, op by op, and differ only
  in the order of the norm sums (lamb's trust ratio, the clip) or, for
  muon, of the Newton-Schulz products' sums, each a few float32 ulps of
  an update of size ~lr.
- Muon's routing against the reference's (``tpudist/optim.py``'s
  ``muon_dims`` labels, read off optax's partitioned state) for every
  leaf of a ResNet-18, a ViT and a GPT-2 (its ``qkv``, ``out``, MLP
  kernels and the tied ``wte``), and one muon step on those trees (which
  holds each leaf's reduction and output axes: a wrong matrix view
  orthogonalizes another matrix).
- ``make_optimizer``'s refusals: ``fused=True`` with another optimizer
  raises ``ValueError``, as the reference's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.linen import meta

from tpudist.models import resnet18 as jax_resnet18
from tpudist.models import vit_b16 as jax_vit
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.optim import warmup_cosine as jax_warmup_cosine
from tpudist_torch.interop import (
    gpt2_params_from_flax, resnet_params_from_flax, vit_params_from_flax,
)
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.resnet import resnet18
from tpudist_torch.models.vit import vit_b16
from tpudist_torch.optim import (
    SGD, Lamb, Lion, Muon, decay_mask, make_optimizer, muon_view,
    warmup_cosine)
from torch_threads import two_torch_threads  # noqa: F401

D, H, DH, IN_C, OUT_C = 16, 2, 8, 4, 8
TOL = 1e-6
OPTIMIZERS = ["sgd", "lamb", "lion", "muon"]
CASES = {"plain": (0.0, None, False), "decay_clip": (0.1, 1.0, False),
         "schedule": (0.0, None, True)}


def _flax_tree(seed):
    r = np.random.Generator(np.random.PCG64(seed))
    n = lambda *s: r.standard_normal(s).astype(np.float32)
    return {"conv": {"kernel": n(3, 3, IN_C, OUT_C)},
            "block_0": {"qkv": {"kernel": n(D, 3, H, DH), "bias": n(3, H, DH)},
                        "out": {"kernel": n(H, DH, D), "bias": n(D)}},
            "mlp": {"kernel": n(D, 24), "bias": n(24)}}


def _to_port(tree) -> dict:
    """The flax-named tree in the port's names and layouts."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    qkv, out = tree["block_0"]["qkv"], tree["block_0"]["out"]
    return {
        "conv.weight": t(np.transpose(tree["conv"]["kernel"], (3, 2, 0, 1))),
        "block_0.qkv.weight": t(np.asarray(qkv["kernel"]).reshape(D, -1).T),
        "block_0.qkv.bias": t(qkv["bias"]),
        "block_0.out.weight": t(np.asarray(out["kernel"]).reshape(-1, D).T),
        "block_0.out.bias": t(out["bias"]),
        "mlp.weight": t(np.asarray(tree["mlp"]["kernel"]).T),
        "mlp.bias": t(tree["mlp"]["bias"]),
    }


def _run_both(optimizer, case, steps=3):
    wd, clip, sched = CASES[case]
    jlr = jax_warmup_cosine(1e-2, warmup_steps=0, total_steps=10) \
        if sched else 1e-2
    tlr = warmup_cosine(1e-2, warmup_steps=0, total_steps=10) \
        if sched else 1e-2
    tx = jax_make_optimizer(jlr, optimizer=optimizer, weight_decay=wd,
                            clip_norm=clip)
    params = jax.tree_util.tree_map(jnp.asarray, _flax_tree(0))
    state = tx.init(params)
    mine = make_optimizer(tlr, optimizer=optimizer, weight_decay=wd,
                          clip_norm=clip)
    tparams = _to_port(_flax_tree(0))
    tstate = mine.init(tparams)
    for i in range(steps):
        grads = _flax_tree(100 + i)
        up, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                              state, params)
        params = optax.apply_updates(params, up)
        mine.step(tstate, tparams, _to_port(grads))
    return _to_port(jax.tree_util.tree_map(np.asarray, params)), tparams, \
        tstate


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_three_steps_match_the_reference(optimizer, case):
    want, got, state = _run_both(optimizer, case)
    assert state.count == 3
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=TOL,
                                   rtol=0, err_msg=k)


def test_make_optimizer_builds_the_references_choices():
    assert type(make_optimizer(optimizer="sgd")) is SGD
    assert make_optimizer(optimizer="sgd").momentum == 0.9
    lion = make_optimizer(optimizer="lion")
    assert type(lion) is Lion and (lion.b1, lion.b2) == (0.9, 0.99)
    lamb = make_optimizer(optimizer="lamb", weight_decay=0.1)
    assert type(lamb) is Lamb and lamb.mask is decay_mask and lamb.eps == 1e-8
    muon = make_optimizer(optimizer="muon")
    assert type(muon) is Muon and (muon.adam_b1, muon.adam_b2) == (0.9, 0.999)
    for name in ("lion", "sgd", "lamb", "muon"):
        with pytest.raises(ValueError, match="adam/adamw update only"):
            make_optimizer(fused=True, optimizer=name)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(optimizer="adagrad")


def _muon_labels(tree) -> list[bool]:
    """The reference's muon routing of every leaf of the flax ``tree``, in
    tree order: True where its muon partition keeps a moment."""
    tx = jax_make_optimizer(1e-2, optimizer="muon")
    state = tx.init(tree)
    mu = state.inner_states["muon"].inner_state[0].mu
    return [not isinstance(x, optax.MaskedNode) for x in
            jax.tree_util.tree_leaves(
                mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))]


def _tiny_vit(**kw):
    return dict(num_classes=10, patch_size=8, hidden_dim=32, depth=2,
                num_heads=4, mlp_dim=64, **kw)


def _flax_vit():
    m = jax_vit(**_tiny_vit())
    return meta.unbox(m.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                             train=False))["params"]


GPT2_GEOM = dict(vocab_size=64, max_seq_len=16, hidden_dim=32, depth=2,
                 num_heads=4)


def _flax_gpt2():
    m = JGPT2(**GPT2_GEOM)
    return meta.unbox(m.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                             train=False))["params"]


def _flax_resnet():
    m = jax_resnet18(num_filters=8)
    v = m.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)
    return v["params"], v["batch_stats"]


def _port_names(tree, convert) -> list[str]:
    """The port name of every leaf of the flax ``tree``, in tree order:
    each leaf filled with its index + 1, passed through ``convert``, and
    found by that value."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    marked = treedef.unflatten([np.full(np.shape(x), i + 1, np.float32)
                                for i, x in enumerate(leaves)])
    sd = convert(marked)
    where = {int(t.reshape(-1)[0]): k for k, t in sd.items()}
    return [where[i + 1] for i in range(len(leaves))]


def _models():
    vit_params = _flax_vit()
    res_params, res_stats = _flax_resnet()
    zeros = jax.tree_util.tree_map(np.zeros_like, res_stats)
    return {
        "vit": (vit_params, vit_params_from_flax,
                vit_b16(**_tiny_vit(), image_size=32, device="cpu")),
        "resnet18": (res_params, lambda t: resnet_params_from_flax(t, zeros),
                     resnet18(num_filters=8, device="cpu")),
        "gpt2": (_flax_gpt2(), gpt2_params_from_flax,
                 GPT2(**GPT2_GEOM, device="cpu")),
    }


@pytest.mark.parametrize("name", ["vit", "resnet18", "gpt2"])
def test_muon_routing_is_the_references(name):
    tree, convert, model = _models()[name]
    params = dict(model.named_parameters())
    names = _port_names(tree, convert)
    assert sorted(names) == sorted(params)
    labels = _muon_labels(tree)
    routed = [muon_view(k, params[k]) is not None for k in names]
    assert routed == labels, [n for n, a, b in zip(names, routed, labels)
                              if a != b]
    assert any(routed) and not all(routed)


@pytest.mark.parametrize("name", ["vit", "resnet18", "gpt2"])
def test_muon_step_on_model_leaves_matches_the_reference(name):
    """One muon step (weight decay on) over every leaf of the model, from
    the reference's init, on gradients drawn per leaf: the reference's
    matrix view of each kernel is the port's leaf reshaped, up to its
    transpose."""
    tree, convert, _ = _models()[name]
    r = np.random.Generator(np.random.PCG64(5))
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    grads = treedef.unflatten([r.standard_normal(np.shape(x)).astype(
        np.float32) for x in leaves])
    tx = jax_make_optimizer(1e-2, optimizer="muon", weight_decay=0.1)
    up, _ = jax.jit(tx.update)(grads, tx.init(tree), tree)
    want = convert(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(tree, up)))
    params = convert(jax.tree_util.tree_map(np.asarray, tree))
    mine = make_optimizer(1e-2, optimizer="muon", weight_decay=0.1)
    mine.step(mine.init(params), params,
              convert(jax.tree_util.tree_map(np.asarray, grads)))
    for k, w in want.items():
        np.testing.assert_allclose(params[k].numpy(), w.numpy(), atol=TOL,
                                   rtol=0, err_msg=k)
