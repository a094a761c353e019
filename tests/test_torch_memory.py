"""The port's memory accounting (tpudist_torch.memory) against
tpudist.memory: the activation estimate over a grid of policies, the
parameter bytes of a small GPT-2 and a small Llama (equal to the
reference's ``state_bytes`` params row), the optimizer-state bytes (the
reference's optax Adam state holds one int32 step counter, ``count``, as a
device scalar; the port keeps its count on the host, so the reference's
row is the port's plus those 4 bytes), ``format_budget``'s line on one
report, the budget built on the meta device, and the CPU's fail-soft
stats."""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist import memory as J
from tpudist import mesh as mesh_lib
from tpudist.models.gpt2 import GPT2 as JaxGPT2
from tpudist.models.llama import Llama as JaxLlama
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.train import create_train_state as jax_create_train_state
from tpudist_torch import memory as M
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.llama import Llama
from tpudist_torch.models.vit import vit_b16
from tpudist_torch.optim import make_optimizer
from tpudist_torch.train import create_train_state
from torch_threads import two_torch_threads  # noqa: F401

#: the reference's optax Adam state counts steps in one int32 device scalar
REFERENCE_COUNT_BYTES = 4

GPT2_GEOM = dict(vocab_size=96, max_seq_len=32, hidden_dim=32, depth=2,
                 num_heads=4)
LLAMA_GEOM = dict(vocab_size=96, max_seq_len=32, hidden_dim=32, depth=2,
                  num_heads=4, num_kv_heads=2, ffn_dim=64)


@pytest.mark.parametrize("policy", ["none", "dots_saveable", "full",
                                    "save_nothing", False, None, True])
def test_activation_estimate_is_the_references(policy):
    for b, s, h, d, heads, scores, dtb in itertools.product(
            (1, 8), (128, 1024), (768, 4096), (2, 12), (None, 12),
            (False, True), (2, 4)):
        kw = dict(num_heads=heads, remat_policy=policy, dtype_bytes=dtb,
                  attention_scores=scores)
        assert M.transformer_activation_bytes(b, s, h, d, **kw) == \
            J.transformer_activation_bytes(b, s, h, d, **kw)
    with pytest.raises(ValueError, match="unknown remat policy"):
        M.transformer_activation_bytes(1, 1, 1, 1, remat_policy="some")


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_state_bytes_are_the_references(arch):
    jm, pm, geom = ((JaxGPT2, GPT2, GPT2_GEOM) if arch == "gpt2"
                    else (JaxLlama, Llama, LLAMA_GEOM))
    mesh = mesh_lib.create_mesh(devices=jax.devices()[:1])
    jstate = jax_create_train_state(jm(**geom), 0, jnp.zeros((1, 8), jnp.int32),
                                    jax_make_optimizer(1e-3), mesh)
    want = J.state_bytes(jstate)
    state = create_train_state(pm(**geom, device="cpu"), make_optimizer(1e-3))
    got = M.state_bytes(state)
    assert got["params"] == want["params"]
    assert got["params"]["global"] == M.tree_bytes(state.model)
    assert M.tree_size(state.params()) == J.tree_size(jstate.params)
    assert (want["opt_state"]["global"] - got["opt_state"]["global"]
            == REFERENCE_COUNT_BYTES)
    assert got["total"]["per_device"] == sum(
        got[k]["per_device"] for k in ("params", "opt_state", "batch_stats"))
    # a placement over the tensor axis: the leaf's shard, ceil-divided
    name, leaf = next(iter(state.params().items()))
    on_tensor = {name: (0, 2, "tensor")}
    halved = M.per_device_bytes(state.params(), shardings=on_tensor)
    assert M.tree_bytes(state.params()) - halved == \
        (leaf.shape[0] // 2) * leaf[0].numel() * leaf.element_size()
    # a placement over the pipe axis (a stacked leaf's layers, as the
    # reference places them): the same ceil division
    on_pipe = {name: (0, 2, "pipe")}
    assert M.per_device_bytes(state.params(), shardings=on_pipe) == halved
    # a placement over the expert axis (a stacked expert leaf's experts):
    # the same ceil division; an axis the port does not lay out raises
    on_expert = {name: (0, 2, "expert")}
    assert M.state_bytes(state, shardings={"params": on_expert})[
        "params"]["per_device"] == halved
    assert M.per_device_bytes(state.params(), shardings=on_expert) == halved
    with pytest.raises(ValueError, match="'sequence'"):
        M.per_device_bytes(state.params(),
                           shardings={name: (0, 2, "sequence")})


def test_budget_line_is_the_references():
    model = GPT2(**GPT2_GEOM, device="cpu")
    report = M.train_state_budget(
        lambda dev: GPT2(**GPT2_GEOM, attn_impl="vmem", device=dev),
        make_optimizer(1e-3), batch=4, seq=32, hbm_budget_bytes=16 << 30)
    n = sum(p.numel() for p in model.parameters())
    assert report["n_params"] == n and report["params_bytes"] == 4 * n
    # Adam's two float32 moments a parameter (the count lives on the host)
    assert report["opt_state_bytes_per_chip"] == 8 * n
    assert report["activation_bytes_est"] == J.transformer_activation_bytes(
        4, 32, 32, 2, num_heads=4)
    assert report["fits"]
    assert M.format_budget(report) == J.format_budget(report)
    for cols in ({"xla_static_bytes": 3 << 30},
                 {"live_peak_bytes": 5 << 29},
                 {"xla_static_bytes": 1 << 30, "live_peak_bytes": 1 << 31}):
        assert M.format_budget(report, **cols) == J.format_budget(report,
                                                                  **cols)


def test_budget_on_meta_allocates_nothing_and_counts_a_compute_copy():
    """A ViT with 16-pixel patches and the fused optimizer's bf16 copy,
    built on the meta device: the parameters as the step holds them
    (bf16) and the state's float32 masters and moments."""
    built = []

    def vit(dev):
        built.append(vit_b16(patch_size=16, image_size=64, hidden_dim=64,
                             depth=2, num_heads=4, mlp_dim=128, device=dev))
        return built[-1]

    report = M.train_state_budget(
        vit, make_optimizer(1e-3, fused=True, compute_dtype=torch.bfloat16),
        batch=8, seq=17, hbm_budget_bytes=80 * 10**9)
    assert all(p.is_meta for p in built[0].parameters())
    n = sum(p.numel() for p in built[0].parameters())
    assert report["n_params"] == n and report["params_bytes"] == 2 * n
    assert 12 * n <= report["opt_state_bytes_per_chip"] < 12 * n + (1 << 20)
    # a plan over an expert axis (tests/test_torch_ep_train.py trains
    # it): test_budget_under_an_expert_plan


@pytest.mark.parametrize("axes", [dict(data=2, pipe=2),
                                  dict(data=1, pipe=2, tensor=2)],
                         ids=["data2-pipe2", "pipe2-tensor2"])
def test_budget_under_a_pipe_plan_is_the_references(axes):
    """``train_state_budget(plan=)`` over a pipe axis against the
    reference's on the same plan of 4 CPU devices with its
    ``PipelinedGPT2`` (blocks stacked and placed over pipe): a rank holds
    one stage's blocks and the replicated rest, its activations
    ``depth / pipe`` layers; the reference's int32 Adam count aside."""
    from tpudist.models.gpt2 import PipelinedGPT2 as JPipelined
    from tpudist.parallel.plan import ParallelPlan as JPlan

    geom = dict(vocab_size=64, max_seq_len=32, hidden_dim=64, depth=4,
                num_heads=4)
    plan = JPlan.build(devices=jax.devices()[:4], **axes)
    want = J.train_state_budget(
        JPipelined(plan.mesh, num_micro=2, **geom), jax_make_optimizer(1e-3),
        jnp.zeros((1, 8), jnp.int32), batch=8, seq=32, plan=plan,
        hbm_budget_bytes=1 << 34)
    got = M.train_state_budget(
        lambda d: GPT2(**geom, device=d), make_optimizer(1e-3), batch=8,
        seq=32, plan=types.SimpleNamespace(**axes), hbm_budget_bytes=1 << 34)
    for k in ("params_bytes", "grad_bytes", "activation_bytes_est",
              "n_params", "params_bytes_global", "pipe_world",
              "tensor_world", "plan"):
        assert got[k] == want[k], k
    for k in ("opt_state_bytes_per_chip", "opt_state_bytes_global"):
        assert got[k] == want[k] - REFERENCE_COUNT_BYTES, k
    # a stage's blocks: half the blocks, the embeddings whole
    assert got["pipe_world"] == 2 and got["params_bytes"] < \
        got["params_bytes_global"]


def test_the_cpu_reports_no_live_stats(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert M.device_memory_stats() is None
    assert M.device_memory_stats("cpu") is None
    assert M.budget_columns(None) == {"estimate_bytes": None,
                                      "xla_static_bytes": None,
                                      "live_peak_bytes": None}
    with pytest.raises(ValueError, match="hbm_budget_bytes is required"):
        M.train_state_budget(lambda d: GPT2(**GPT2_GEOM, device=d),
                             make_optimizer(1e-3), batch=1, seq=8)
    assert np.isclose(M.budget_columns({"per_chip_total_bytes": 7})[
        "estimate_bytes"], 7)


@pytest.mark.parametrize("axes", [dict(data=2, expert=2),
                                  dict(data=1, expert=2, tensor=2)],
                         ids=["data2-expert2", "expert2-tensor2"])
def test_budget_under_an_expert_plan(axes):
    """``train_state_budget(plan=)`` over an expert axis against the
    reference's on the same plan of 4 CPU devices with its MoE GPT-2 (the
    stacked expert leaves placed over ``expert``, their ffn dim over
    ``tensor``): a rank holds half of each expert leaf; the reference's
    int32 Adam count aside."""
    from tpudist.parallel.plan import ParallelPlan as JPlan

    geom = dict(vocab_size=64, max_seq_len=32, hidden_dim=64, depth=2,
                num_heads=4, num_experts=4)
    plan = JPlan.build(devices=jax.devices()[:4], **axes)
    want = J.train_state_budget(
        JaxGPT2(**geom, mesh=plan.mesh), jax_make_optimizer(1e-3),
        jnp.zeros((2, 8), jnp.int32), batch=8, seq=32, plan=plan,
        hbm_budget_bytes=1 << 34)
    got = M.train_state_budget(
        lambda d: GPT2(**geom, device=d), make_optimizer(1e-3), batch=8,
        seq=32, plan=types.SimpleNamespace(**axes), hbm_budget_bytes=1 << 34)
    for k in ("params_bytes", "grad_bytes", "n_params",
              "params_bytes_global", "expert_world", "tensor_world"):
        assert got[k] == want[k], k
    assert got["opt_state_bytes_per_chip"] == \
        want["opt_state_bytes_per_chip"] - REFERENCE_COUNT_BYTES
    whole = M.train_state_budget(
        lambda d: GPT2(**geom, device=d), make_optimizer(1e-3), batch=8,
        seq=32, plan=types.SimpleNamespace(data=4), hbm_budget_bytes=1 << 34)
    moe = GPT2(**geom, device="meta").h[1].moe
    half = sum(getattr(moe, n).numel() for n in moe.expert_leaves) * 4 // 2
    assert whole["params_bytes"] - got["params_bytes"] >= half
