"""The port's MoE layer (``tpudist_torch.parallel.ep``) against the JAX
package's ``tpudist.parallel.ep`` on the CPU, from the same inputs.

- ``expert_capacity`` equal; ``top_k_routing``'s ``idx``, ``pos`` and
  ``keep`` equal on the same float32 probabilities (exact ties and
  capacity drops among them), ``gates`` and the aux loss at float32
  rounding (``GATE_RTOL``), batched over groups as the layer runs it.
- The dispatches' slots: ``_one_hot_dispatch`` (dispatch and combine)
  and ``_index_dispatch`` against the reference's from the same routing.
- ``MoEMlp`` (GELU and SwiGLU experts, top-1 and top-2, einsum and index
  dispatch, capacity 1.0 so choices drop): the output and the gradients
  of the input, the router and the experts against the reference layer's
  from the same weights (``FWD_*`` / ``GRAD_*`` bars); the port's two
  dispatches against each other; the z-loss; the jitter's gating.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tpudist.parallel import ep as J
from tpudist_torch.parallel import ep as P

#: float32 rounding of the gates and the aux loss (the same ops, summed in
#: another order)
GATE_RTOL = 1e-6
#: the layer's output: float32 contractions summed in another order
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
#: the gradients, relative to each leaf's largest element
GRAD_REL = 1e-5
#: the port's index dispatch against its einsum dispatch (the reference's
#: own bar between its two, tests/test_moe.py)
IMPL_ATOL = 5e-7


@pytest.mark.parametrize("t,e,k,cf", [
    (16, 4, 2, 1.25), (1, 8, 2, 1.25), (1024, 8, 2, 1.25), (5, 8, 2, 1.0),
    (7, 3, 1, 2.0), (2048, 8, 2, 1.25)])
def test_expert_capacity(t, e, k, cf):
    assert P.expert_capacity(t, e, top_k=k, capacity_factor=cf) == \
        J.expert_capacity(t, e, top_k=k, capacity_factor=cf)


def _probs(shape, seed, ties: bool):
    """float32 router probabilities; ``ties``: integer logits in a small
    range, so many rows hold exact ties."""
    rng = np.random.Generator(np.random.PCG64(seed))
    logits = (rng.integers(0, 3, shape).astype(np.float32) if ties
              else rng.standard_normal(shape).astype(np.float32))
    return np.array(jax.nn.softmax(jnp.asarray(logits)))


ROUTING = [(k, ties, cap) for k in (1, 2, 3) for ties in (False, True)
           for cap in (2, 6)]


@pytest.mark.parametrize("k,ties,cap", ROUTING)
def test_routing_matches_the_reference(k, ties, cap):
    probs = _probs((3, 24, 6), 7 + k, ties)
    got = P.top_k_routing(torch.from_numpy(probs), k, cap)
    for g, p in enumerate(probs):
        want = J.top_k_routing(jnp.asarray(p), k, cap)
        for name, a, b in zip(("idx", "pos", "keep"), got[:3], want[:3]):
            np.testing.assert_array_equal(a[g].numpy(), np.asarray(b),
                                          err_msg=name)
        np.testing.assert_allclose(got[1][g].numpy(), np.asarray(want[1]),
                                   rtol=GATE_RTOL)
        np.testing.assert_allclose(float(got[4][g]), float(want[4]),
                                   rtol=GATE_RTOL)
    keep = got[3].numpy()
    if cap == 2:
        assert not keep.all()  # capacity drops among the cases


@pytest.mark.parametrize("k", [1, 2])
def test_dispatches_fill_the_references_slots(k):
    E, C = 6, 3
    probs = _probs((2, 24, E), 3, True)
    rng = np.random.Generator(np.random.PCG64(4))
    tokens = rng.standard_normal((2, 24, 8)).astype(np.float32)
    idx, gates, pos, keep, _ = P.top_k_routing(torch.from_numpy(probs), k, C)
    disp, comb = P._one_hot_dispatch(idx, gates, pos, keep, E, C,
                                     torch.float32)
    dest = P._flat_dest(idx, pos, keep, C, E)
    slots = P._index_dispatch(torch.from_numpy(tokens), dest, E, C)
    for g in range(2):
        j = J.top_k_routing(jnp.asarray(probs[g]), k, C)
        jd, jc = J._one_hot_dispatch(*j[:4], E, C, jnp.float32)
        np.testing.assert_array_equal(disp[g].numpy(), np.asarray(jd))
        np.testing.assert_allclose(comb[g].numpy(), np.asarray(jc),
                                   rtol=GATE_RTOL)
        jdest = J._flat_dest(j[0], j[2], j[3], C, E)
        np.testing.assert_array_equal(dest[g].numpy(), np.asarray(jdest))
        np.testing.assert_array_equal(
            slots[g].numpy(),
            np.asarray(J._index_dispatch(jnp.asarray(tokens[g]), jdest, E,
                                         C)))


D, E, FF = 16, 4, 24


def _layers(act, k, impl, **kw):
    ref = J.MoEMlp(num_experts=E, top_k=k, capacity_factor=1.0, ffn_dim=FF,
                   expert_act=act, dispatch_impl=impl, **kw)
    port = P.MoEMlp(D, E, top_k=k, capacity_factor=1.0, ffn_dim=FF,
                    expert_act=act, dispatch_impl=impl, device="cpu", **kw)
    return ref, port


def _x(seed=5, shape=(2, 12, D)):
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.standard_normal(shape).astype(np.float32)


def _params(ref, x, seed=0):
    p = ref.init(jax.random.key(seed), jnp.asarray(x))["params"]
    return jax.tree_util.tree_map(np.asarray, meta.unbox(p))


def _load(port, params):
    with torch.no_grad():
        for k, v in params.items():
            getattr(port, k).copy_(torch.from_numpy(np.array(v)))
    return port


def _ref_loss(ref, params, x, cot):
    y, upd = ref.apply({"params": params}, x, mutable=["losses"])
    return jnp.sum(y * cot) + sum(jax.tree_util.tree_leaves(upd["losses"]))


LAYER = [(act, k, impl) for act in ("gelu", "swiglu") for k in (1, 2)
         for impl in ("einsum", "index")]


@pytest.mark.parametrize("act,k,impl", LAYER)
def test_layer_and_gradients_match_the_reference(act, k, impl):
    x = _x()
    ref, port = _layers(act, k, impl)
    params = _params(ref, x)
    _load(port, params)
    cot = np.random.Generator(np.random.PCG64(9)).standard_normal(
        x.shape).astype(np.float32)
    want_y = ref.apply({"params": params}, jnp.asarray(x))
    loss, (gp, gx) = jax.value_and_grad(
        lambda p, xx: _ref_loss(ref, p, xx, jnp.asarray(cot)),
        argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    got = (y * torch.from_numpy(cot)).sum() + P.moe_losses(port)
    np.testing.assert_allclose(float(got.detach()), float(loss),
                               rtol=FWD_RTOL)
    got.backward()
    assert port.stats()["dropped"] > 0  # capacity 1.0 drops choices
    pairs = [("x", xt.grad, gx)] + [
        (n, getattr(port, n).grad, gp[n]) for n in params]
    for name, g, w in pairs:
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_index_dispatch_matches_einsum_dispatch(act):
    x = torch.from_numpy(_x(11))
    ref, einsum = _layers(act, 2, "einsum")
    params = _params(ref, x.numpy())
    _, index = _layers(act, 2, "index")
    _load(einsum, params)
    _load(index, params)
    np.testing.assert_allclose(index(x).detach().numpy(),
                               einsum(x).detach().numpy(), rtol=0,
                               atol=IMPL_ATOL)


def test_router_z_loss_matches_the_reference():
    x = _x()
    ref, port = _layers("gelu", 2, "einsum", router_z_loss=1.0)
    params = _params(ref, x)
    params["router"] = params["router"] * 10.0
    _load(port, params)
    _, upd = ref.apply({"params": params}, jnp.asarray(x),
                       mutable=["losses"])
    port(torch.from_numpy(x))
    assert set(port.losses) == {"aux", "z"}
    np.testing.assert_allclose(float(port.losses["z"].detach()),
                               float(upd["losses"]["moe_router_z_loss"]),
                               rtol=GATE_RTOL)
    np.testing.assert_allclose(float(port.losses["aux"].detach()),
                               float(upd["losses"]["moe_aux_loss"]),
                               rtol=GATE_RTOL)
    # off by default: the aux loss alone
    _, off = _layers("gelu", 2, "einsum")
    _load(off, params)(torch.from_numpy(x))
    assert set(off.losses) == {"aux"}


def test_router_jitter_gating():
    x = torch.from_numpy(_x())
    ref, jit = _layers("gelu", 2, "einsum", router_jitter=0.2)
    params = _params(ref, x.numpy())
    _, base = _layers("gelu", 2, "einsum")
    _load(jit, params)
    _load(base, params)
    want = base(x)
    # eval (train=False, the default): the jitter-free layer, bit for bit
    assert torch.equal(jit(x), want)
    assert torch.equal(jit(x, train=False, jitter_key=3), want)
    # train without a key: a loud refusal
    with pytest.raises(ValueError, match="dropout_key"):
        jit(x, train=True)
    # train with a key: the routing input moves, the same key draws the
    # same noise
    noisy = jit(x, train=True, jitter_key=1)
    assert not torch.equal(noisy, want)
    assert torch.equal(jit(x, train=True, jitter_key=1), noisy)


def test_num_experts_must_divide_the_expert_axis():
    import types

    with pytest.raises(ValueError, match="not divisible by the mesh's "
                                         "expert=3 axis"):
        P.MoEMlp(D, 4, layout=types.SimpleNamespace(expert=3, tensor=1),
                 device="cpu")


# ---------------------------------------------------------------------------
# the MoE models: three Adam steps against the reference's step


from tpudist.models.gpt2 import GPT2 as JGPT2  # noqa: E402
from tpudist.models.lm_utils import chunked_lm_forward as jax_chunked  # noqa: E402
from tpudist.train import lm_loss as jax_lm_loss  # noqa: E402
from tpudist_torch.interop import (  # noqa: E402
    gpt2_params_from_flax, llama_params_from_flax)
from tpudist_torch.models.gpt2 import GPT2  # noqa: E402
from tpudist_torch.models.llama import Llama  # noqa: E402
from tpudist_torch.models.lm_utils import chunked_lm_forward  # noqa: E402
from tpudist_torch.optim import make_optimizer  # noqa: E402
from tpudist_torch.train import lm_loss, make_train_step  # noqa: E402

from torch_composed import assert_close, reference  # noqa: E402
from torch_threads import two_torch_threads  # noqa: E402,F401

V, S, B, STEPS, LR = 64, 16, 4, 3, 1e-3
MOE = dict(num_experts=4, capacity_factor=1.25)
LM_GEOM = {
    "gpt2": dict(max_seq_len=S, hidden_dim=32, depth=2, num_heads=4,
                 moe_every=1, **MOE),
    "llama": dict(max_seq_len=S, hidden_dim=32, depth=2, num_heads=4,
                  num_kv_heads=2, ffn_dim=48, **MOE),
}


def _batches(seed=21, steps=STEPS):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [rng.integers(0, V, (B, S)).astype(np.int32)
            for _ in range(steps)]


def _port_lm(arch, init, **kw):
    cls = GPT2 if arch == "gpt2" else Llama
    model = cls(vocab_size=V, **LM_GEOM[arch], device="cpu", **kw)
    model.load_state_dict(init)
    return model


#: an element whose gradient at init is below this share of its leaf's
#: largest is one Adam moves on rounding noise (``m / (sqrt(v) + eps)``
#: of a ~1e-9 gradient: a GELU of a very negative input in one expert's
#: slot); it is held to the step bound ``1.5 x steps x lr``, as
#: tests/torch_composed.py holds the qkv key bias, whose gradient is zero
NOISE_SHARE = 1e-5


def init_grads(model, batch):
    """The gradients of ``model``'s step loss (CE plus aux) at its
    weights on ``batch``, by name (the noise elements' selector)."""
    model.train()
    t = torch.from_numpy(batch)
    (lm_loss(model(t), t) + P.moe_losses(model)).backward()
    out = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    model.zero_grad()
    return out


def assert_adam_close(got, want_losses, want, grads):
    """:func:`assert_close`'s bars, with each element Adam moves on noise
    (:data:`NOISE_SHARE`) held to the step bound instead."""
    bound = 1.5 * STEPS * LR
    noise = {}
    for k, g in grads.items():
        g = g.numpy()
        mask = np.abs(g) <= NOISE_SHARE * np.abs(g).max()
        if k.endswith("qkv.bias") or not mask.any():
            continue
        noise[k] = mask
    kept = {"losses": got["losses"], "params": dict(got["params"])}
    ref = dict(want)
    for k, mask in noise.items():
        g, w = kept["params"][k].numpy(), np.asarray(ref[k])
        assert np.abs(g - w)[mask].max() <= bound, k
        kept["params"][k] = torch.from_numpy(np.where(mask, w, g))
    assert_close(kept, want_losses, ref, sgd=False, steps=STEPS, lr=LR)


def _port_steps(model, batches, fused=None):
    tx = make_optimizer(LR, weight_decay=0.0, clip_norm=None,
                        fused=fused is not None)
    from tpudist_torch.train import create_train_state

    state = create_train_state(model, tx)
    step = make_train_step(model, tx, loss_fn=lm_loss, input_key="tokens",
                           label_key="tokens", fused=fused)
    losses = []
    for b in batches:
        state, m = step(state, {"tokens": torch.from_numpy(b)})
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": state.params()}


MODEL_CASES = [("gpt2", "einsum", None), ("gpt2", "index", None),
               ("gpt2", "index", "all"), ("llama", "einsum", None),
               ("llama", "index", "all")]


@pytest.mark.parametrize("arch,impl,fused", MODEL_CASES)
def test_moe_lm_trains_like_the_reference(arch, impl, fused):
    """The first loss and three Adam steps of the MoE GPT-2 (every block
    MoE) and the Mixtral-style Llama against the reference's step on one
    device from its init, under both dispatches; ``fused="all"`` runs the
    fused LN and AdamW's plain versions here (tests/torch_composed.py's
    bars)."""
    import optax

    batches = _batches()
    geom = dict(LM_GEOM[arch], moe_dispatch=impl)
    init, losses, final = reference(arch, optax.adam(LR), batches,
                                    mesh={"data": 1}, vocab=V, geom=geom)
    grads = init_grads(_port_lm(arch, init, moe_dispatch=impl), batches[0])
    got = _port_steps(_port_lm(arch, init, moe_dispatch=impl), batches,
                      fused)
    assert_adam_close(got, losses, final, grads)


def test_chunked_forward_carries_the_aux_loss():
    """The chunked head's loss of an MoE GPT-2 is the chunked CE plus the
    blocks' aux losses (tests/test_moe.py's check), equal to the
    reference's chunked loss from the same weights."""
    model_j = JGPT2(vocab_size=V, **LM_GEOM["gpt2"])
    tokens = _batches(6, 1)[0]
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(model_j.init(
        jax.random.key(0), tokens, train=False)["params"]))
    want, _ = jax_chunked(model_j, chunk=8)(params, {}, {"tokens": tokens})
    logits, upd = model_j.apply({"params": params}, tokens, train=True,
                                mutable=["losses"])
    aux_j = sum(jax.tree_util.tree_leaves(upd["losses"]), 0.0)
    model = _port_lm("gpt2", gpt2_params_from_flax(params))
    model.train()
    t = torch.from_numpy(tokens)
    chunked = chunked_lm_forward(model, chunk=8)(model, {"tokens": t})
    aux = P.moe_losses(model)
    assert float(aux.detach()) > 0
    np.testing.assert_allclose(float(aux.detach()), float(aux_j),
                               rtol=GATE_RTOL)
    plain = lm_loss(model(t), t) + P.moe_losses(model)
    chunked, plain = float(chunked.detach()), float(plain.detach())
    np.testing.assert_allclose(chunked, plain, rtol=1e-6)
    np.testing.assert_allclose(chunked, float(want), rtol=1e-5)
    np.testing.assert_allclose(float(want),
                               float(jax_lm_loss(logits, tokens) + aux_j),
                               rtol=1e-5)


def test_z_loss_joins_the_step_loss():
    """``router_z_loss`` on: the step's loss is the CE plus every block's
    aux and z-loss (the reference's sowed losses), against the
    reference's first loss."""
    import optax

    geom = dict(LM_GEOM["gpt2"], router_z_loss=0.1)
    batches = _batches(3, 1)
    init, losses, _ = reference("gpt2", optax.adam(LR), batches,
                                mesh={"data": 1}, vocab=V, geom=geom)
    model = _port_lm("gpt2", init, router_z_loss=0.1)
    got = _port_steps(model, batches)
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    assert all(set(m.losses) == {"aux", "z"} for m in P.moe_layers(model))


def test_router_jitter_in_the_step():
    """Jitter draws from the step's dropout stream: a jitter run trains
    another trajectory than a jitter-free one, the same seed the same;
    ``forward_loss`` (no stream) and the chunked head refuse it in the
    reference's words."""
    init = GPT2(vocab_size=V, **LM_GEOM["gpt2"], device="cpu").state_dict()
    batches = _batches(4, 2)
    runs = [_port_steps(_port_lm("gpt2", init, router_jitter=j), batches)
            for j in (0.0, 0.2, 0.2)]
    assert runs[1]["losses"][1] != runs[0]["losses"][1]
    assert runs[1]["losses"] == runs[2]["losses"]
    model = _port_lm("gpt2", init, router_jitter=0.2)
    tx = make_optimizer(LR)
    with pytest.raises(ValueError, match="router_jitter=0.2 but "
                                         "forward_loss has no rng stream"):
        make_train_step(model, tx, forward_loss=lambda m, b: 0.0)
    with pytest.raises(ValueError, match="does not support router_jitter"):
        chunked_lm_forward(model, chunk=8)


def test_router_takes_the_compute_copy_as_the_reference():
    """Under the fused AdamW's bf16 compute copy the reference casts every
    float leaf, the float32 router included (its einsum then promotes the
    bf16 router to float32); the port's copy does the same."""
    from tpudist.optim import fused_adamw as jax_fused_adamw

    model_j = JGPT2(vocab_size=V, **LM_GEOM["gpt2"])
    params = model_j.init(jax.random.key(0), np.zeros((1, S), np.int32),
                          train=False)["params"]
    st = jax_fused_adamw(LR, compute_dtype=jnp.bfloat16).init(
        meta.unbox(params))
    assert st.compute["h_0"]["moe"]["router"].dtype == jnp.bfloat16
    model = _port_lm("gpt2", gpt2_params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(params))),
        dtype=torch.bfloat16)
    tx = make_optimizer(LR, fused=True, compute_dtype=torch.bfloat16)
    tx.init(dict(model.named_parameters()))
    assert model.h[0].moe.router.dtype == torch.bfloat16
    # the logits: the bf16 router upcast, as the reference's promotion
    x = torch.randn(1, 4, 32)
    model.h[0].moe(x.to(torch.bfloat16))
    assert model.h[0].moe.losses["aux"].dtype == torch.float32


def test_llama_moe_converts_and_mixtral_geometry():
    """``llama_params_from_flax`` carries the ``moe`` subtrees; the
    Mixtral-8x7B geometry is the reference's."""
    from tpudist.models.llama import Llama as JLlama
    from tpudist.models.llama import mixtral_8x7b as jax_mixtral
    from tpudist_torch.models.llama import mixtral_8x7b

    jm = JLlama(vocab_size=V, **LM_GEOM["llama"])
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(jm.init(
        jax.random.key(1), np.zeros((1, S), np.int32), train=False)[
        "params"]))
    sd = llama_params_from_flax(params)
    assert {k for k in sd if ".moe." in k} == {
        f"layer_{i}.moe.{n}" for i in range(2)
        for n in ("router", "w_gate", "w_up", "w_down")}
    model = _port_lm("llama", sd)
    tokens = _batches(8, 1)[0]
    np.testing.assert_allclose(
        model(torch.from_numpy(tokens)).detach().numpy(),
        np.asarray(jm.apply({"params": params}, tokens, train=False)),
        rtol=1e-4, atol=1e-5)
    want = jax_mixtral(depth=1)
    got = mixtral_8x7b(depth=1, device="meta")
    for f in ("hidden_dim", "num_heads", "num_kv_heads", "ffn_dim",
              "vocab_size", "rope_theta", "max_seq_len", "num_experts",
              "moe_every"):
        assert getattr(got, f) == getattr(want, f), f
    # 1,713M parameters at depth 1: the embedding and the untied head,
    # attention (GQA 32/8), the experts, the router, three RMSNorms
    n = sum(p.numel() for p in got.parameters())
    assert n == (2 * 32000 * 4096 + 2 * 4096 * (4096 + 1024)
                 + 8 * 3 * 4096 * 14336 + 4096 * 8 + 3 * 4096)


@pytest.mark.parametrize("impl", ["einsum", "index"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_collectives_hand_over_contiguous_buffers(impl, dtype,
                                                         monkeypatch):
    """NCCL refuses a strided tensor where gloo copies it: every buffer the
    expert axis's all_gather and all_reduce send (the slot outputs, which
    the expert FFN leaves transposed, and the tokens' cotangent) is
    contiguous, in float32 for half precision. The collectives are stood
    in for by one rank's copies."""
    import types

    sent = []

    def all_gather(parts, t, group=None):
        sent.append(t)
        for p in parts:
            p.copy_(t)

    def all_reduce(t, group=None):
        sent.append(t)

    monkeypatch.setattr(P.dist, "all_gather", all_gather)
    monkeypatch.setattr(P.dist, "all_reduce", all_reduce)
    layout = types.SimpleNamespace(expert=2, expert_idx=0, expert_group=None,
                                   tensor=1)
    moe = P.MoEMlp(D, E, ffn_dim=FF, dispatch_impl=impl, dtype=dtype,
                   layout=layout, device="cpu")
    moe.init_weights(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x()).to(dtype).requires_grad_()
    moe(x).float().sum().backward()
    assert len(sent) == 2 and x.grad is not None
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in sent)
