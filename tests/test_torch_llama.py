"""The port's Llama (tpudist_torch.models.llama) against the JAX reference
(tpudist.models.llama) on the same weights, carried across by
``interop.llama_params_from_flax``, at depth 2, width 64, S <= 64 on the
CPU: RoPE, the logits and every parameter gradient (MHA and GQA, tied and
untied heads, the RMSNorms plain and through the fused kernel, which runs
in interpret mode on the JAX side), the scanned layout, per-block remat,
three AdamW steps of ``make_train_step`` against ``tpudist.train``, the
chunked loss's head, the HF bridge (against ``tpudist.interop`` and
transformers' ``LlamaForCausalLM``) and the LM CLI's ``--arch llama``
against ``examples/train_gpt2.py``.

Tolerances (float32 on both sides; the frameworks reduce in different
orders on the CPU): logits 2e-5 absolute, as tests/test_torch_gpt2.py;
RoPE 1e-6 absolute (angles up to 905 radians, where one float32 ulp of an
angle is ~6e-5 of it, so sin and cos may part by a few ulps); gradients
within 2e-5 of each leaf's largest magnitude (measured: 2.1e-6 at
worst); the trainer's per-step losses within 1e-5 relative and its
parameters within 1e-4 relative plus 1e-4 absolute after three AdamW
steps at lr 1e-3, as tests/test_torch_gpt2_train.py; the chunked loss
1e-6 relative of the full-logits loss; HF logits 1e-4 absolute, as
tests/test_torch_lm_cli.py."""

import contextlib
import io
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tpudist import mesh as mesh_lib
from tpudist.data.lm import TokenWindowLoader as JaxTokenWindowLoader
from tpudist.interop import llama_params_from_hf as jax_llama_params_from_hf
from tpudist.models.llama import Llama as JLlama
from tpudist.models.llama import apply_rope as jax_apply_rope
from tpudist.models.lm_utils import chunked_lm_forward as jax_chunked
from tpudist.optim import decay_mask as jax_decay_mask
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.optim import run_schedule as jax_run_schedule
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import lm_loss as jax_lm_loss
from tpudist.train import make_train_step as jax_make_train_step
from tpudist_torch import interop
from tpudist_torch.models import llama as L
from tpudist_torch.models.lm_utils import chunked_lm_forward, lm_head_weight
from tpudist_torch.optim import decay_mask, make_optimizer, run_schedule
from tpudist_torch.train import create_train_state, lm_loss, make_train_step
from tpudist_torch.train_gpt2 import main

REPO = Path(__file__).resolve().parent.parent
GEOM = dict(vocab_size=64, max_seq_len=64, hidden_dim=64, depth=2,
            num_heads=4, ffn_dim=128)
ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # several pytest-xdist workers share the host (tests/test_torch_train.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _tokens(shape, seed=0, vocab=64):
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, vocab, shape).astype(np.int32)


def _flax(model, seed=0):
    params = model.init(jax.random.key(seed), np.zeros((1, 8), np.int32),
                        train=False)["params"]
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


def _port(params, **kw):
    model = L.Llama(**{**GEOM, **kw}, device="cpu")
    model.load_state_dict(interop.llama_params_from_flax(params))
    return model


@pytest.mark.parametrize("theta", [1e4, 5e5])
@pytest.mark.parametrize("positions", ["none", "[S]", "[B,S]"])
def test_apply_rope_matches_the_reference(positions, theta):
    rng = np.random.Generator(np.random.PCG64(1))
    x = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    pos = {"none": None,
           "[S]": np.arange(64, dtype=np.float32) + 3,
           "[B,S]": (np.arange(64)[None] + np.array([[5], [841]])).astype(
               np.float32)}[positions]
    want = jax_apply_rope(jnp.asarray(x), theta=theta, positions=None
                          if pos is None else jnp.asarray(pos))
    got = L.apply_rope(torch.from_numpy(x), theta=theta, positions=None
                       if pos is None else torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    # bf16 in, bf16 out: rotated in float32, rounded once
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = L.apply_rope(xb, theta=theta)
    assert gb.dtype == torch.bfloat16
    torch.testing.assert_close(
        gb, L.apply_rope(xb.float(), theta=theta).to(torch.bfloat16),
        atol=0, rtol=0)


#: (num_kv_heads, tie_embeddings, fused_ln)
MODEL_CASES = [(4, False, False), (2, False, False), (2, True, False),
               (2, False, True), (4, True, True)]


@pytest.mark.parametrize("kv,tie,fused", MODEL_CASES,
                         ids=lambda v: str(v))
def test_logits_and_gradients_match_the_reference(kv, tie, fused):
    """MHA and GQA 4/2, tied and untied, the RMSNorms plain and fused: the
    logits, then every parameter's gradient of the next-token loss."""
    kw = dict(num_kv_heads=kv, tie_embeddings=tie, fused_ln=fused)
    jm = JLlama(**GEOM, **kw)
    params = _flax(jm, seed=kv + 2 * tie)
    toks = _tokens((2, 24), seed=kv)
    model = _port(params, **kw)
    got = model(torch.from_numpy(toks).long()).detach().numpy()
    want = jm.apply({"params": params}, toks, train=False)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)

    def jloss(p):
        return jax_lm_loss(jm.apply({"params": p}, toks, train=True), toks)

    jgrads = interop.llama_params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.grad(jloss)(params)))
    model.train()
    lm_loss(model(torch.from_numpy(toks).long()),
            torch.from_numpy(toks).long()).backward()
    named = dict(model.named_parameters())
    assert named.keys() == jgrads.keys()
    for k, w in jgrads.items():
        g = named[k].grad.numpy()
        np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                   atol=2e-5 * float(w.abs().max()),
                                   err_msg=k)


def test_parameter_names_and_shapes_are_the_references():
    """The state dict carries the reference's tree leaf for leaf (names
    and ``[out, in]`` weights of its ``[in, out...]`` kernels); the decay
    mask exempts exactly the 1-D RMSNorm scales, as the reference's."""
    jm = JLlama(**GEOM, num_kv_heads=2)
    params = _flax(jm)
    model = _port(params, num_kv_heads=2)
    sd = model.state_dict()
    d, h, kv, dh, ffn = 64, 4, 2, 16, 128
    assert sd["embed"].shape == sd["lm_head"].shape == (64, d)
    blk = {k.split(".", 1)[1]: v.shape for k, v in sd.items()
           if k.startswith("layer_0.")}
    assert blk == {"attn_norm.scale": (d,), "mlp_norm.scale": (d,),
                   "q_proj.weight": (h * dh, d), "k_proj.weight": (kv * dh, d),
                   "v_proj.weight": (kv * dh, d), "o_proj.weight": (d, h * dh),
                   "gate_proj.weight": (ffn, d), "up_proj.weight": (ffn, d),
                   "down_proj.weight": (d, ffn)}
    assert len(sd) == 3 + 9 * GEOM["depth"]
    np.testing.assert_array_equal(
        sd["layer_1.o_proj.weight"].numpy().T.reshape(h, dh, d),
        params["layer_1"]["o_proj"]["kernel"])
    got = decay_mask(dict(model.named_parameters()))
    want = interop.llama_params_from_flax(jax.tree_util.tree_map(
        lambda m: np.full(np.shape(m), m, np.float32),
        jax_decay_mask(params)))
    assert {k: bool(v) for k, v in got.items()} == {
        k: bool(np.all(v.numpy())) for k, v in want.items()}
    assert {k for k, on in got.items() if not on} == {
        k for k in sd if k.endswith(".scale")}
    assert L.default_ffn_dim(768) == 2048 and L.default_ffn_dim(4096) == 11008


def test_scan_layers_matches_unrolled_and_layouts_round_trip():
    """The reference's scanned model (params stacked under ``layers``)
    carried into the port's model gives the unrolled model's logits; the
    port's ``scan_layers`` model computes what the unrolled one does;
    stack/unstack move a state dict between the layouts and back exactly,
    and stack refuses a wrong depth."""
    toks = _tokens((2, 12), seed=4)
    unrolled = JLlama(**GEOM, num_kv_heads=2)
    params = _flax(unrolled, seed=5)
    from tpudist.models.llama import stack_llama_layers as jax_stack

    scanned_params = jax.tree_util.tree_map(
        np.asarray, jax_stack(params, GEOM["depth"]))
    want = JLlama(**GEOM, num_kv_heads=2, scan_layers=True).apply(
        {"params": scanned_params}, toks, train=False)
    for layout in (params, scanned_params):
        got = _port(layout, num_kv_heads=2, scan_layers=True)(
            torch.from_numpy(toks).long()).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    sd = _port(params, num_kv_heads=2).state_dict()
    stacked = L.stack_llama_layers(sd, GEOM["depth"])
    np.testing.assert_array_equal(
        stacked["layers.block.q_proj.weight"].numpy(),
        np.stack([sd[f"layer_{i}.q_proj.weight"].numpy() for i in range(2)]))
    back = L.unstack_llama_layers(stacked)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match="refusing"):
        L.stack_llama_layers(sd, 3)
    with pytest.raises(ValueError, match="remat_layers requires scan_layers"):
        L.Llama(**GEOM, remat_layers=True, device="cpu")
    with pytest.raises(ValueError, match="no decode path"):
        m = L.Llama(**GEOM, scan_layers=True, device="cpu")
        m(torch.zeros(1, 1, dtype=torch.long), cache=m.init_cache(1))


@pytest.mark.parametrize("policy", ["full", "dots_saveable", "save_nothing"])
def test_remat_policy_leaves_loss_and_gradients_unchanged(policy):
    """Per-block checkpointing recomputes the same float32 function: the
    loss and every gradient bit-identical to no remat (and ``remat_layers``
    with ``scan_layers`` is ``full``)."""
    toks = torch.from_numpy(_tokens((2, 16), seed=6)).long()
    runs = []
    for kw in ({}, {"remat_policy": policy},
               {"scan_layers": True, "remat_layers": True}):
        model = L.Llama(**GEOM, num_kv_heads=2, fused_ln=True, device="cpu",
                        seed=3, **kw).train()
        loss = lm_loss(model(toks), toks)
        loss.backward()
        runs.append((loss.detach(), {k: p.grad.clone() for k, p in
                                     model.named_parameters()}))
    (l0, g0), *rest = runs
    for loss, grads in rest:
        assert torch.equal(loss, l0)
        assert all(torch.equal(grads[k], g0[k]) for k in g0)


@pytest.mark.parametrize("fused,attn", [(None, "xla"), ("ln", "xla"),
                                        ("all", "vmem")],
                         ids=["unfused", "fused-ln", "fused-all-vmem"])
def test_three_adamw_steps_match_the_reference(fused, attn):
    """``make_train_step`` on a GQA Llama (S 64, vocab 256) against
    ``tpudist.train.make_train_step`` on identical weights and batches:
    AdamW with warmup, decay and clipping, the fused RMSNorm kernel under
    ``fused="ln"``, and the vmem kernel with the fused optimizer under
    ``"all"`` (both Pallas kernels in interpret mode on the JAX side)."""
    geom = dict(GEOM, vocab_size=256, num_kv_heads=2)
    batch, steps, seq = 2, 3, 64
    rng = np.random.Generator(np.random.PCG64(1))
    loader = JaxTokenWindowLoader(rng.integers(0, 256, 4000).astype(np.int32),
                                  batch, seq)
    batches = [b for _, b in zip(range(steps), loader)]
    mesh = mesh_lib.create_mesh(devices=jax.devices()[:1])
    jm = JLlama(**geom, attn_impl=attn)
    opt_kw = dict(weight_decay=0.1, clip_norm=1.0, fused=fused == "all")
    jtx = jax_make_optimizer(
        jax_run_schedule(1e-3, total_steps=steps, warmup_steps=1), **opt_kw)
    jstate = jax_create_train_state(jm, 0, jnp.zeros((1, seq), jnp.int32),
                                    jtx, mesh)
    init = interop.llama_params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(jstate.params)))
    jstep = jax_make_train_step(jm, jtx, mesh, loss_fn=jax_lm_loss,
                                input_key="tokens", label_key="tokens",
                                fused=fused)
    want_losses = []
    for b in batches:
        jstate, metrics = jstep(jstate, b)
        want_losses.append(float(metrics["loss"]))

    model = L.Llama(**geom, attn_impl=attn, device="cpu")
    model.load_state_dict(init)
    tx = make_optimizer(run_schedule(1e-3, total_steps=steps, warmup_steps=1),
                        **opt_kw)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, loss_fn=lm_loss, input_key="tokens",
                           label_key="tokens", fused=fused)
    assert model.fused_ln == (fused in ("ln", "all"))
    losses = []
    for b in batches:
        state, metrics = step(state, {"tokens": torch.from_numpy(b["tokens"])})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = interop.llama_params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(jstate.params)))
    got = state.params()
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("tie", [False, True], ids=["lm_head", "tied-embed"])
def test_chunked_loss_takes_the_llama_head(tie):
    """``chunked_lm_forward`` on a Llama reads ``lm_head`` (``embed`` when
    tied) and gives the full-logits loss and its gradients, as the
    reference's ``tests/test_llama.py::test_chunked_ce_matches_full_logits``
    holds its own; its value is the reference's chunked loss."""
    jm = JLlama(**GEOM, num_kv_heads=2, tie_embeddings=tie)
    params = _flax(jm, seed=7)
    toks = _tokens((2, 16), seed=7)
    model = _port(params, num_kv_heads=2, tie_embeddings=tie).train()
    assert lm_head_weight(model) is (model.embed if tie else model.lm_head)
    t = torch.from_numpy(toks).long()
    full = lm_loss(model(t), t)
    full.backward()
    want_grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad()
    got = chunked_lm_forward(model, chunk=5)(model, {"tokens": t})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(full.detach()),
                               rtol=1e-6)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    jgot, _ = jax_chunked(jm, chunk=5)(params, {}, {"tokens": toks})
    np.testing.assert_allclose(float(got.detach()), float(jgot), rtol=1e-6)


def test_compute_copy_and_geometry():
    """The engine's copy holds the linears, ``embed`` and ``lm_head`` in
    the compute dtype and the RMSNorm scales in float32; the run meta's
    model geometry names the arch and the GQA and SwiGLU fields (and the
    experts of an MoE model); Mixtral's geometry is the reference's
    (tests/test_torch_ep.py trains the MoE blocks)."""
    model = L.Llama(**GEOM, num_kv_heads=2, dtype=torch.bfloat16,
                    device="cpu")
    held = model.compute_copy()
    dtypes = {k: p.dtype for k, p in held.named_parameters()}
    assert {k for k, dt in dtypes.items() if dt == torch.float32} == {
        k for k in dtypes if k.endswith(".scale")}
    assert held.compute_copy() is held and model.embed.dtype == torch.float32
    assert model.geometry == {
        "arch": "llama", "vocab_size": 64, "hidden_dim": 64, "depth": 2,
        "num_heads": 4, "num_kv_heads": 2, "ffn_dim": 128,
        "rope_theta": 10000.0, "tie_embeddings": False}
    moe = L.Llama(**GEOM, num_experts=4, device="cpu")
    assert moe.geometry["num_experts"] == 4 and moe.geometry["moe_every"] == 1
    assert all(hasattr(b, "moe") for b in moe.blocks)
    mixtral = L.mixtral_8x7b(depth=1, device="meta")
    assert (mixtral.hidden_dim, mixtral.num_kv_heads, mixtral.ffn_dim,
            mixtral.num_experts) == (4096, 8, 14336, 8)
    assert L.llama3_8b.__doc__ and L.llama2_7b.__doc__


# ---------------------------------------------------------------------------
# the HF bridge and the CLI

S, DEPTH, HEADS, KV, WIDTH = 32, 2, 4, 2, 64
ARGS = ["--arch", "llama", "--num_kv_heads", str(KV), "--ffn_dim", "128",
        "--vocab_size", "256", "--seq_len", str(S), "--hidden_dim",
        str(WIDTH), "--depth", str(DEPTH), "--num_heads", str(HEADS),
        "--no_profiler"]
TEXT = b"the quick brown fox jumps over the lazy dog. " * 40


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """A random-init HF ``LlamaForCausalLM`` (GQA 4/2, untied) saved as
    safetensors, the model, and a byte-token file of three steps of 8
    windows."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")
        try:
            from transformers import LlamaConfig, LlamaForCausalLM
        except ImportError:
            pytest.skip("transformers is not installed")
    from tpudist_torch.data.lm import encode_bytes

    root = tmp_path_factory.mktemp("hf_llama")
    torch.manual_seed(0)
    cfg = LlamaConfig(vocab_size=256, hidden_size=WIDTH, intermediate_size=128,
                      num_hidden_layers=DEPTH, num_attention_heads=HEADS,
                      num_key_value_heads=KV, max_position_embeddings=S,
                      rms_norm_eps=1e-5, rope_theta=10000.0,
                      tie_word_embeddings=False, attention_bias=False,
                      mlp_bias=False)
    model = LlamaForCausalLM(cfg).eval()
    model.save_pretrained(root / "st", safe_serialization=True)
    encode_bytes(TEXT)[:3 * 8 * S].astype(np.uint16).tofile(root / "train.bin")
    return types.SimpleNamespace(st=root / "st", model=model, cfg=cfg,
                                 train=root / "train.bin")


def test_hf_bridge_is_the_references_and_transformers(hf, tmp_path):
    """``load_hf_params(arch="llama")`` gives the reference's params
    (carried over by ``llama_params_from_flax``) exactly, the port's model
    on them computes transformers' logits, ``save_hf_checkpoint`` round
    trips and transformers reads it back to the same logits."""
    from safetensors.torch import load_file

    got = interop.load_hf_params(hf.st, arch="llama", depth=DEPTH,
                                 num_heads=HEADS, num_kv_heads=KV)
    hf_sd = load_file(str(hf.st / "model.safetensors"))
    want = interop.llama_params_from_flax(jax_llama_params_from_hf(
        {k: v.numpy() for k, v in hf_sd.items()}, depth=DEPTH,
        num_heads=HEADS, num_kv_heads=KV))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    model = L.Llama(vocab_size=256, max_seq_len=S, hidden_dim=WIDTH,
                    depth=DEPTH, num_heads=HEADS, num_kv_heads=KV,
                    ffn_dim=128, device="cpu")
    model.load_state_dict(got)
    tokens = torch.from_numpy(_tokens((2, S), seed=8, vocab=256)).long()
    with torch.no_grad():
        logits = model(tokens)
        want_logits = hf.model(tokens).logits
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), atol=1e-4,
                               rtol=0)
    back = interop.llama_params_from_hf(
        interop.llama_params_to_hf(got, depth=DEPTH), depth=DEPTH,
        num_heads=HEADS, num_kv_heads=KV)
    assert all(torch.equal(back[k], got[k]) for k in got)
    interop.save_hf_checkpoint(got, tmp_path, arch="llama", depth=DEPTH)
    hf.cfg.save_pretrained(tmp_path)
    from transformers import LlamaForCausalLM

    reread = LlamaForCausalLM.from_pretrained(tmp_path).eval()
    with torch.no_grad():
        assert torch.equal(reread(tokens).logits, want_logits)
    with pytest.raises(ValueError, match="K/V heads"):
        interop.load_hf_params(hf.st, arch="llama", depth=DEPTH,
                               num_heads=HEADS)
    # a tied model writes the embedding as lm_head, read back as tied
    tied = {k: v for k, v in got.items() if k != "lm_head"}
    assert "lm_head" not in interop.llama_params_from_hf(
        interop.llama_params_to_hf(tied, depth=DEPTH), depth=DEPTH,
        num_heads=HEADS, num_kv_heads=KV)


def _reference_cli(argv):
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import train_gpt2 as ref
    finally:
        sys.path.pop(0)
    with contextlib.redirect_stdout(io.StringIO()):
        return ref.main([*ARGS, *argv])


def test_cli_arch_llama_matches_the_reference_cli(hf, tmp_path):
    """``--arch llama --num_kv_heads 2`` from the same HF checkpoint
    (``--init_hf``) on the same tokens: three AdamW steps' losses and the
    parameters against ``examples/train_gpt2.main`` (whose 8 emulated
    devices take one sequence each of the port's batch of 8)."""
    flags = ["--tokens", str(hf.train), "--init_hf", str(hf.st), "--lr",
             "1e-3", "--warmup_steps", "0", "--log_dir", str(tmp_path)]
    jstate, want_losses = _reference_cli([*flags, "--batch_size", "1"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state, losses = main([*ARGS, "--device", "cpu", *flags,
                              "--batch_size", "8"])
    assert len(losses) == len(want_losses) == 3
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert isinstance(state.model, L.Llama) and state.model.num_kv_heads == KV
    assert "tokens/sec: " in out.getvalue()
    want = interop.llama_params_from_flax(jax.tree_util.tree_map(
        np.asarray, jstate.params))
    got = state.params()
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_cli_arch_llama_runs_its_legs(tmp_path):
    """The Llama CLI with the fused kernels' CPU paths, a whole-forward
    remat, the chunked head, --eval, --generate and a checkpoint whose
    meta records the geometry: a resume with other K/V heads is
    refused."""
    ck = tmp_path / "ck"
    flags = [*ARGS, "--device", "cpu", "--synthetic_tokens", "2048",
             "--batch_size", "4", "--log_dir", str(tmp_path)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state, losses = main([*flags, "--fused", "all", "--attn", "vmem",
                              "--remat", "full", "--chunked_ce", "8",
                              "--eval", "--generate", "8", "--temperature",
                              "0", "--total_steps", "4",
                              "--checkpoint_dir", str(ck),
                              "--checkpoint_every", "8"])
    text = out.getvalue()
    assert np.isfinite(losses).all() and len(losses) == 16
    assert "val_loss: " in text and "generated tokens: " in text
    import json

    meta_ = json.loads((ck / "tpudist_meta.json").read_text())
    assert meta_["model"]["arch"] == "llama"
    assert meta_["model"]["num_kv_heads"] == KV
    with pytest.raises(ValueError, match="different geometry"):
        with contextlib.redirect_stdout(io.StringIO()):
            main([*flags, "--num_kv_heads", "4", "--checkpoint_dir",
                  str(ck)])
