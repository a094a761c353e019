"""The port's fused AdamW (tpudist_torch.ops.fused_update, optim.fused_adamw
and the unfused optax-order Adam) against the JAX reference on the same
inputs: the leaf update against tpudist's ``fused_leaf_update`` (its
Pallas kernel interpreted on the CPU), the optimizers over 5 steps
against tpudist's ``fused_adamw`` and the optax chain, the compute-copy
contract, and the CUDA entry point's refusal of CPU tensors.

Tolerances are tests/test_fused_update.py's: 1e-6 absolute on the
[40, 130] and [9001] leaves (the kernel path) and 5e-7 on the small
leaves, a few float32 ulps at ~2.0-magnitude params after 5 compounding
Adam steps (XLA may fuse and reassociate where PyTorch rounds op by op).
The bf16 copy is held bit-exact. The multi-tensor step's plain version is
held bit-equal to the per-leaf path it replaced, and its launch plan to
covering every element once (hypothesis)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpudist.ops.fused_update import fused_leaf_update as jax_leaf_update
from tpudist.optim import decay_mask as jax_decay_mask
from tpudist.optim import fused_adamw as jax_fused_adamw
from tpudist_torch.ops import fused_update as F
from tpudist_torch.optim import (
    Adam, decay_mask, fused_adamw, make_optimizer, warmup_cosine)
from torch_threads import two_torch_threads  # noqa: F401

TOL = {"w": 1e-6, "big": 1e-6, "b": 5e-7, "one": 5e-7}
HP = dict(b1=0.9, b2=0.999, eps=1e-8)


def _tree(seed=0):
    r = np.random.Generator(np.random.PCG64(seed))
    return {
        "w": r.standard_normal((40, 130)).astype(np.float32),
        "big": r.standard_normal(9001).astype(np.float32),
        "b": r.standard_normal(7).astype(np.float32),
        "one": np.asarray(r.standard_normal(1)[0], np.float32),
    }


def _grads(params, seed, dtype=np.float32):
    r = np.random.Generator(np.random.PCG64(seed))
    # sorted: jax.tree_util returns dicts in key order
    out = {k: np.asarray(r.standard_normal(params[k].shape) * 0.1, np.float32)
           for k in sorted(params)}
    if dtype != np.float32:  # round through bf16 for both frameworks
        out = {k: np.asarray(jnp.asarray(g, jnp.bfloat16)) for k, g in out.items()}
    return out


def _torch_grad(g):
    if g.dtype == np.float32:
        return torch.from_numpy(np.array(g))
    return torch.from_numpy(np.asarray(g, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("copy", [None, "bfloat16"])
def test_leaf_update_matches_jax(gdtype, wd, copy):
    params = _tree()
    grads = _grads(params, 7, np.float32 if gdtype == "float32" else "bf16")
    r = np.random.Generator(np.random.PCG64(1))
    lr, b1c, b2c = np.float32(3e-3), np.float32(0.271), np.float32(0.002997)
    for key, p in params.items():
        m = np.asarray(r.standard_normal(p.shape) * 0.01, np.float32)
        v = np.asarray(r.random(p.shape) * 1e-3, np.float32)
        ju, jm, jv, jc = jax_leaf_update(
            jnp.asarray(grads[key]), jnp.asarray(m), jnp.asarray(v),
            jnp.asarray(p), lr, b1c, b2c, wd=wd,
            compute_dtype=None if copy is None else jnp.bfloat16, **HP)
        tu, tm, tv, tc = F.fused_leaf_update(
            _torch_grad(grads[key]), torch.from_numpy(m), torch.from_numpy(v),
            torch.from_numpy(np.array(p)), float(lr), float(b1c), float(b2c),
            wd=wd, compute_dtype=None if copy is None else torch.bfloat16, **HP)
        for got, want in ((tu, ju), (tm, jm), (tv, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL[key], rtol=0)
        if copy is None:
            assert tc is None and jc is None
        else:
            # the copy is the cast of the post-update master, to the bit
            np.testing.assert_array_equal(
                tc.float().numpy(),
                (torch.from_numpy(p) + tu).to(torch.bfloat16).float().numpy())
            np.testing.assert_array_equal(tc.float().numpy(),
                                          np.asarray(jc, np.float32))
    assert F.launch_counts["fused_adamw"] == 0  # CPU tensors: plain version


def _jax_run(tx, params, steps=5, gdtype=np.float32):
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(params)

    @jax.jit
    def step(p, s, g):
        u, s2 = tx.update(g, s, p)
        return optax.apply_updates(p, u), s2

    for i in range(steps):
        g = jax.tree_util.tree_map(jnp.asarray, _grads(params, 100 + i, gdtype))
        params, state = step(params, state, g)
    return {k: np.asarray(v) for k, v in params.items()}


def _port_run(tx, params, steps=5, gdtype=np.float32):
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    state = tx.init(tparams)
    for i in range(steps):
        g = {k: _torch_grad(v) for k, v in _grads(params, 100 + i, gdtype).items()}
        tx.step(state, tparams, g)
    return {k: v.float().numpy() for k, v in _masters(state, tparams).items()}


def _masters(state, params):
    return getattr(state, "master", params)


CASES = {
    "adam": (0.0, None, False),         # plain adam
    "adamw_mask": (0.1, None, False),   # adamw + decay mask
    "clip_sched": (0.1, 1.0, True),     # + global-norm clip + lr schedule
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
def test_fused_adamw_matches_jax_fused_adamw(case, gdtype):
    wd, clip, sched = CASES[case]
    gd = np.float32 if gdtype == "float32" else "bf16"
    params = _tree()
    jlr = optax.cosine_decay_schedule(1e-2, 50) if sched else 1e-2
    tlr = warmup_cosine(1e-2, warmup_steps=0, total_steps=50) if sched else 1e-2
    want = _jax_run(jax_fused_adamw(jlr, weight_decay=wd, clip_norm=clip,
                                    mask=jax_decay_mask if wd else None),
                    params, gdtype=gd)
    got = _port_run(fused_adamw(tlr, weight_decay=wd, clip_norm=clip,
                                mask=decay_mask if wd else None),
                    params, gdtype=gd)
    for key in params:
        np.testing.assert_allclose(got[key], want[key], atol=TOL[key], rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_unfused_adam_matches_optax(case):
    """The port's unfused Adam follows optax's arithmetic (not
    ``torch.optim.Adam``'s). float32 gradients: optax squares a bf16
    gradient in bf16, the port in float32, as the fused paths do."""
    wd, clip, sched = CASES[case]
    params = _tree()
    jlr = optax.cosine_decay_schedule(1e-2, 50) if sched else 1e-2
    tlr = warmup_cosine(1e-2, warmup_steps=0, total_steps=50) if sched else 1e-2
    parts = ([optax.clip_by_global_norm(clip)] if clip else []) + [
        optax.adamw(jlr, weight_decay=wd, mask=jax_decay_mask) if wd
        else optax.adam(jlr)]
    want = _jax_run(optax.chain(*parts), params)
    got = _port_run(Adam(tlr, weight_decay=wd, clip_norm=clip,
                         mask=decay_mask if wd else None), params)
    for key in params:
        np.testing.assert_allclose(got[key], want[key], atol=TOL[key], rtol=0)


def test_make_optimizer_defaults_are_the_references_adam():
    tx = make_optimizer()
    assert type(tx) is Adam and tx.learning_rate == 1e-3
    assert (tx.b1, tx.b2, tx.eps, tx.weight_decay) == (0.9, 0.999, 1e-8, 0.0)
    fused = make_optimizer(fused=True, compute_dtype=torch.bfloat16,
                           weight_decay=0.1)
    assert fused.fused and fused.compute_dtype == torch.bfloat16
    assert fused.mask is decay_mask
    # the reference's other choices and its guard are ported; fused=True
    # takes adam only, as the reference's does
    assert type(make_optimizer(optimizer="sgd")).__name__ == "SGD"
    guarded = make_optimizer(skip_nonfinite_updates=True)
    assert type(guarded.inner) is Adam and not guarded.fused
    with pytest.raises(ValueError, match="adam/adamw update only"):
        make_optimizer(optimizer="sgd", fused=True)


def test_compute_copy_is_cast_of_post_update_master():
    params = {k: torch.from_numpy(np.array(v)) for k, v in _tree().items()}
    tx = fused_adamw(1e-2, compute_dtype=torch.bfloat16)
    state = tx.init(params)
    for k, p in params.items():
        assert state.master[k] is not p
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, state.master[k].to(torch.bfloat16))
    for i in range(3):
        g = {k: _torch_grad(v).to(torch.bfloat16)
             for k, v in _grads(_tree(), 100 + i).items()}
        tx.step(state, params, g)
    for k, p in params.items():
        assert state.master[k].dtype == torch.float32
        # BIT-identical to casting the post-update master
        assert torch.equal(p, state.master[k].to(torch.bfloat16))
    # without a compute dtype the parameters are the masters
    pstate = fused_adamw(1e-2).init(params)
    assert all(pstate.master[k] is p for k, p in params.items())


def test_decay_mask_masks_1d_leaves():
    params = {k: torch.from_numpy(np.array(v)) for k, v in _tree().items()}
    before = {k: v.clone() for k, v in params.items()}
    tx = fused_adamw(1e-2, weight_decay=0.5, mask=decay_mask)
    tx.step(tx.init(params), params,
            {k: torch.zeros_like(v) for k, v in params.items()})
    assert torch.equal(params["b"], before["b"])      # masked: no decay
    assert torch.equal(params["one"], before["one"])
    assert not torch.equal(params["w"], before["w"])  # decayed


def test_cuda_entry_point_refuses_cpu_tensors():
    """The kernel's entry point never falls back: a CPU tensor (or a
    machine without a card) raises before anything is built."""
    t = torch.zeros(2048)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        F.fused_leaf_update_cuda(t, t, t, t, 1e-3, 0.1, 0.001, **HP)
    assert F.launch_counts["fused_adamw"] == 0


def test_layout_rule_ignores_size_one_dims():
    """The kernel walks flat storage, so every operand must lay its
    elements out as the master does. A 1x1 conv weight in channels-last
    (strides (512, 1, 512, 512)) and its contiguous gradient (512, 1, 1, 1)
    are one layout; a 3x3 weight's two layouts are not."""
    cl = torch.channels_last
    p = torch.empty(2048, 512, 1, 1).to(memory_format=cl)
    assert p.stride() != torch.empty(2048, 512, 1, 1).stride()
    assert F._same_layout(torch.empty(2048, 512, 1, 1), p)
    q = torch.empty(64, 64, 3, 3).to(memory_format=cl)
    assert F._same_layout(torch.empty_like(q), q)
    assert not F._same_layout(torch.empty(64, 64, 3, 3), q)
    assert not F._same_layout(torch.empty(64, 64, 9), q)


def _model_leaves(model):
    """A small ResNet's or a tiny GPT-2's parameters on the CPU (BatchNorm
    and LayerNorm leaves of a few elements among them)."""
    if model == "resnet":
        from tpudist_torch.models.resnet import resnet18

        net = resnet18(num_filters=4, num_classes=10, device="cpu")
    else:
        from tpudist_torch.models.gpt2 import GPT2

        net = GPT2(vocab_size=64, max_seq_len=16, hidden_dim=32, depth=2,
                   num_heads=4, device="cpu")
    return [p.detach() for p in net.parameters()]


def _leaf_state(leaves, seed, gdtype, copy):
    """Random g (rounded through bf16 for a bf16 g), m, v, masters and
    zeroed copies per leaf, from numpy, and a decay on leaves of more than
    one dimension (decay_mask)."""
    r = np.random.Generator(np.random.PCG64(seed))
    f = lambda p, scale=1.0, pos=False: torch.from_numpy(np.asarray(
        (r.random(p.shape) if pos else r.standard_normal(p.shape)) * scale,
        np.float32))
    return dict(
        g=[f(p, 0.1).to(getattr(torch, gdtype)) for p in leaves],
        m=[f(p, 0.01) for p in leaves], v=[f(p, 1e-3, True) for p in leaves],
        p=[f(p) for p in leaves],
        copy=[None if copy is None else torch.zeros(p.shape,
                                                    dtype=torch.bfloat16)
              for p in leaves],
        wd=[0.1 if p.ndim > 1 else 0.0 for p in leaves])


def _clone_table(s):
    c = lambda ts: [None if t is None else t.clone() for t in ts]
    return F.AdamWTable(c(s["m"]), c(s["v"]), c(s["p"]), c(s["copy"]), s["wd"])


@pytest.mark.parametrize("model", ["resnet", "gpt2"])
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("copy", [None, "bfloat16"])
def test_plain_step_equals_per_leaf_path_plus_master_add(model, gdtype, copy):
    """The multi-tensor step's plain version is, to the bit, what the
    optimizer ran before it: ``fused_leaf_update`` per leaf (the plain
    formula under the per-leaf threshold too) writing m, v and the copy in
    place, then ``master += u``; over every leaf of a small ResNet and a
    tiny GPT-2, small leaves included."""
    leaves = _model_leaves(model)
    assert any(p.numel() < F.MIN_KERNEL_ELEMS for p in leaves)
    assert any(p.numel() >= F.MIN_KERNEL_ELEMS for p in leaves)
    s = _leaf_state(leaves, 3, gdtype, copy)
    lr, b1c, b2c = 3e-3, 0.271, 0.002997
    step, per_leaf = _clone_table(s), _clone_table(s)
    F.reset_launch_counts()
    F.fused_adamw_step(step, s["g"], lr, b1c, b2c, **HP)
    for g, m, v, p, c, wd in zip(s["g"], per_leaf.m, per_leaf.v, per_leaf.p,
                                 per_leaf.copy, per_leaf.wd):
        u, _, _, _ = F.fused_leaf_update(g, m, v, p, lr, b1c, b2c, wd=wd,
                                         m_out=m, v_out=v, copy_out=c, **HP)
        p.add_(u)
    for name in ("m", "v", "p", "copy"):
        for a, b in zip(getattr(step, name), getattr(per_leaf, name)):
            assert (a is None and b is None) or torch.equal(a, b), name
    assert set(F.launch_counts.values()) == {0}  # CPU: the plain version


class _FakeTable:
    """A table whose first master claims to lie on the card."""

    p = [types.SimpleNamespace(is_cuda=True)]

    def __len__(self):
        return 1


def test_cuda_step_never_takes_the_plain_version(monkeypatch):
    """The multi-tensor entry routes on the masters' device alone: CUDA
    masters go to the kernel wrapper, which refuses anything but CUDA
    tensors (so no failure there can fall back to the plain path)."""
    seen = []
    monkeypatch.setattr(F, "fused_adamw_step_cuda",
                        lambda *a, **k: seen.append("cuda"))
    monkeypatch.setattr(F, "fused_adamw_step_plain",
                        lambda *a, **k: seen.append("plain"))
    F.fused_adamw_step(_FakeTable(), [None], 1e-3, 0.1, 0.001, **HP)
    assert seen == ["cuda"]
    monkeypatch.undo()
    F.reset_launch_counts()
    s = _leaf_state(_model_leaves("gpt2")[:3], 0, "float32", None)
    with pytest.raises(ValueError, match="not CUDA tensors"):
        F.fused_adamw_step_cuda(_clone_table(s), s["g"], 1e-3, 0.1, 0.001,
                                **HP)
    assert set(F.launch_counts.values()) == {0}


def test_fused_adamw_state_holds_one_table_over_every_leaf():
    params = {k: torch.from_numpy(np.array(v)) for k, v in _tree().items()}
    tx = fused_adamw(1e-2, weight_decay=0.1, mask=decay_mask,
                     compute_dtype=torch.bfloat16)
    state = tx.init(params)
    t = state.table
    assert state.names == list(params) and len(t) == len(params)
    for i, k in enumerate(state.names):
        assert t.m[i] is state.mu[k] and t.v[i] is state.nu[k]
        assert t.p[i] is state.master[k] and t.copy[i] is params[k]
    assert t.wd == [0.1 if params[k].ndim > 1 else 0.0 for k in state.names]
    with pytest.raises(ValueError, match="differ from"):
        tx.step(state, dict(reversed(params.items())),
                {k: torch.zeros_like(v) for k, v in params.items()})


@settings(max_examples=60, deadline=None)
@given(sizes=st.lists(st.integers(1, 100_000), max_size=1000),
       groups=st.integers(1, 3), max_leaves=st.sampled_from([1, 7, 480]),
       chunk=st.sampled_from([4096, F.CHUNK_ELEMS]), seed=st.integers(0, 99))
def test_launch_plan_covers_each_element_once(sizes, groups, max_leaves,
                                              chunk, seed):
    """:func:`plan_launches` groups the leaves by dtype, splits a group
    past one table into as many launches as it needs, numbers each
    launch's chunks without gaps, and the kernel's mapping of a chunk to
    (leaf, first element) covers every element of every leaf exactly
    once."""
    r = np.random.Generator(np.random.PCG64(seed))
    keys = [("g", int(k)) for k in r.integers(0, groups, len(sizes))]
    sizes = [0 if r.random() < 0.02 else n for n in sizes]  # a few empty
    plan = F.plan_launches(keys, sizes, max_leaves=max_leaves, chunk=chunk)
    seen = [i for launch in plan for i in launch.idx]
    assert sorted(seen) == [i for i, n in enumerate(sizes) if n]
    for key in set(keys):
        group = [launch for launch in plan if launch.key == key]
        n_group = sum(1 for k, n in zip(keys, sizes) if k == key and n)
        assert len(group) == -(-n_group // max_leaves)
    for launch in plan:
        assert 0 < len(launch.idx) <= max_leaves
        assert all(keys[i] == launch.key for i in launch.idx)
        n = np.array([sizes[i] for i in launch.idx], np.int64)
        counts = -(-n // chunk)
        start = np.array(launch.chunk0, np.int64)
        np.testing.assert_array_equal(start,
                                      np.concatenate([[0], np.cumsum(counts)[:-1]]))
        assert launch.n_chunks == counts.sum()
        # the kernel's walk: chunk c -> the last leaf whose chunk0 <= c
        c = np.arange(launch.n_chunks)
        leaf = np.searchsorted(start, c, side="right") - 1
        begin = (c - start[leaf]) * chunk
        end = np.minimum(begin + chunk, n[leaf])
        assert (begin % chunk == 0).all() and (begin < end).all()
        covered = np.zeros(len(n), np.int64)
        np.add.at(covered, leaf, end - begin)
        np.testing.assert_array_equal(covered, n)
