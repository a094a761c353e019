"""The port's non-finite update guard (tpudist_torch.amp) against
tpudist.amp: ``all_finite`` and ``nonfinite_count`` on the same tensors,
and ``skip_nonfinite`` around Adam, AdamW, the fused step's plain version
and the other optimizers over five steps whose second gradient holds an
inf: after every step the parameters, the moments, the step count and
the skip count agree with the reference's, and the steps after the
skipped one are bit-identical to a port run that never saw the bad
batch. Tolerance 1e-6 absolute on the parameters and moments (the
fused-update tests' bar: a few float32 ulps after five compounding
steps, XLA and PyTorch rounding op by op in different fusions)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpudist import amp as jamp
from tpudist.optim import decay_mask as jax_decay_mask
from tpudist.optim import fused_adamw as jax_fused_adamw
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist_torch import amp
from tpudist_torch.ops import fused_update as FU
from tpudist_torch.optim import make_optimizer

TOL = 1e-6
BAD = 1  # the step (from 0) whose gradient holds an inf


def _tree(seed=0):
    r = np.random.Generator(np.random.PCG64(seed))
    return {"w": r.standard_normal((40, 130)).astype(np.float32),
            "big": r.standard_normal(9001).astype(np.float32),
            "b": r.standard_normal(7).astype(np.float32)}


def _grads(step):
    g = {k: v * np.float32(0.1) for k, v in _tree(100 + step).items()}
    if step == BAD:
        g["big"][17] = np.inf
    return g


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("tensors", [
    {"a": np.ones(3, np.float32), "i": np.arange(3, dtype=np.int32)},
    {"a": np.array([1.0, np.nan], np.float32)},
    {"a": np.array([np.inf, -np.inf, 2.0], np.float32), "b": np.zeros(4,
                                                                   np.float32)},
    {"i": np.arange(4, dtype=np.int32)},
], ids=["finite", "nan", "infs", "ints_only"])
def test_all_finite_and_nonfinite_count_match_the_reference(tensors):
    want_ok = bool(jamp.all_finite({k: jnp.asarray(v)
                                    for k, v in tensors.items()}))
    want_n = int(jamp.nonfinite_count({k: jnp.asarray(v)
                                       for k, v in tensors.items()}))
    got_ok = amp.all_finite(_t(tensors))
    got_n = amp.nonfinite_count(_t(tensors))
    assert got_ok.dtype == torch.bool and bool(got_ok) == want_ok
    assert got_n.dtype == torch.int32 and int(got_n) == want_n


#: name -> (reference optimizer, the port's make_optimizer arguments)
CASES = {
    "adam": (lambda: optax.adam(1e-2), dict()),
    "adamw": (lambda: optax.adamw(1e-2, weight_decay=0.1,
                                  mask=jax_decay_mask),
              dict(weight_decay=0.1)),
    "fused": (lambda: jax_fused_adamw(1e-2, weight_decay=0.1,
                                      mask=jax_decay_mask),
              dict(weight_decay=0.1, fused=True)),
    "fused_clip": (lambda: jax_fused_adamw(1e-2, clip_norm=0.5),
                   dict(clip_norm=0.5, fused=True)),
    "sgd": (lambda: jax_make_optimizer(1e-2, optimizer="sgd"),
            dict(optimizer="sgd")),
    "muon": (lambda: jax_make_optimizer(1e-2, optimizer="muon"),
             dict(optimizer="muon")),
}


def _adam_part(inner):
    """The reference state's (count, mu, nu) holder for the Adam cases."""
    return inner if hasattr(inner, "mu") else inner[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_skip_nonfinite_matches_the_reference(case):
    make_ref, kw = CASES[case]
    jtx = jamp.skip_nonfinite(make_ref())
    jparams = {k: jnp.asarray(v) for k, v in _tree().items()}
    jstate = jtx.init(jparams)
    tx = make_optimizer(1e-2, skip_nonfinite_updates=True, **kw)
    assert isinstance(tx, amp.SkipNonfinite) and tx.fused == ("fused" in case)
    params = _t(_tree())
    state = tx.init(params)
    # the same optimizer fed only the finite gradients
    clean_tx = make_optimizer(1e-2, **kw)
    clean = _t(_tree())
    clean_state = clean_tx.init(clean)
    FU.reset_launch_counts()
    for step in range(5):
        g = _grads(step)
        up, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, up)
        tx.step(state, params, _t(g))
        assert amp.skipped_steps(state) == jamp.skipped_steps(jstate) == \
            (1 if step >= BAD else 0)
        assert amp.maybe_skipped_steps(state) == amp.skipped_steps(state)
        if case.startswith(("adam", "fused")):
            ref = _adam_part(jstate[0])
            assert state.inner.count == int(ref.count) == step + (
                0 if step >= BAD else 1)
            for k in params:
                for mine, want in ((state.inner.mu, ref.mu),
                                   (state.inner.nu, ref.nu)):
                    np.testing.assert_allclose(
                        mine[k].numpy(), np.asarray(want[k]), atol=TOL,
                        rtol=0, err_msg=f"step {step} {k}")
        for k in params:
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(jparams[k]), atol=TOL,
                                       rtol=0, err_msg=f"step {step} {k}")
        if step == BAD:
            # the skipped step left every parameter as it was
            for k in params:
                assert torch.equal(params[k], clean[k])
        else:
            clean_tx.step(clean_state, clean, _t(g))
            for k in params:
                assert torch.equal(params[k], clean[k]), (step, k)
    assert set(FU.launch_counts.values()) == {0}  # CPU: the plain versions
    assert amp.inner_state(state) is state.inner
    assert not amp.is_skip_state(state.inner)
    assert amp.maybe_skipped_steps(state.inner) is None


def test_fused_plain_step_under_a_set_flag_writes_nothing():
    """The fused step's plain version takes the guard's flag as the kernel
    does: set, the moments, masters and copy keep their bits; clear, the
    step is the unguarded one's."""
    params = _t(_tree())
    tx = make_optimizer(1e-2, fused=True, weight_decay=0.1,
                        compute_dtype=torch.bfloat16)
    state = tx.init(params)
    t = state.table
    g = [torch.from_numpy(_grads(0)[k]).to(torch.bfloat16)
         for k in state.names]
    before = [[x.clone() for x in getattr(t, n)] for n in ("m", "v", "p",
                                                         "copy")]
    flag = torch.ones((), dtype=torch.int32)
    FU.fused_adamw_step(t, g, 1e-2, 0.1, 0.001, b1=0.9, b2=0.999, eps=1e-8,
                        nonfinite=flag)
    for name, old in zip(("m", "v", "p", "copy"), before):
        assert all(torch.equal(a, b) for a, b in zip(getattr(t, name), old))
    FU.nonfinite_check(t, g, flag)
    assert int(flag) == 0
    FU.fused_adamw_step(t, g, 1e-2, 0.1, 0.001, b1=0.9, b2=0.999, eps=1e-8,
                        nonfinite=flag)
    tab = FU.AdamWTable([x.clone() for x in before[0]],
                        [x.clone() for x in before[1]],
                        [x.clone() for x in before[2]],
                        [x.clone() for x in before[3]], t.wd)
    FU.fused_adamw_step(tab, g, 1e-2, 0.1, 0.001, b1=0.9, b2=0.999, eps=1e-8)
    for name in ("m", "v", "p", "copy"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(t, name),
                                                     getattr(tab, name)))
    g[1][5] = float("nan")
    FU.nonfinite_check(t, g, flag)
    assert int(flag) == 1
