"""FSDP composed with tensor parallelism (``ParallelPlan.build(fsdp=2,
tensor=2)``, ``parallel.fsdp.compose_fsdp``, ``train_gpt2 --fsdp 2
--tensor 2``) against the JAX package's plan on the same mesh of 4 CPU
devices, in one gloo world of 4 ranks.

- GPT-2 and GQA Llama (V 64, 2 layers, width 32, the plan's threshold at
  256 elements so that FSDP has a leaf to shard at this width): one SGD
  step within ``atol=rtol=1e-5`` and three Adam steps within ``rtol
  2e-4`` (tests/test_parallel_plan.py's bars) of the reference's step.
- The placements: the leaves FSDP shards and those the tensor axis
  places are the reference plan's (its ``_leaf_sharding``: a tensor spec
  is kept, every other leaf takes the fsdp rule), and the bytes a rank
  holds equal the reference's ``per_device_bytes`` under the plan.
- ``train_gpt2 --fsdp 2 --tensor 2 --fused all --chunked_ce 5 --attn
  vmem --eval --generate 4`` against the reference's plan with the CLI's
  schedule; its checkpoint's geometry records ``fsdp_world`` and
  ``tensor_world``, and a resume at ``--tensor 4`` is refused with the
  reference's hint.
- A DCP checkpoint under the plan restores bit for bit.
- ``train_state_budget(plan=)`` at ``data 2 x fsdp 2 x tensor 2`` and
  ``fsdp 2 x tensor 2`` (no world: only the axis sizes are read) equals
  the reference's ``train_state_budget(plan=ParallelPlan.build(data=2,
  fsdp=2, tensor=2))`` (tests/test_parallel_plan.py) component by
  component, with and without ZeRO-1 (its Adam count, an int32 the port
  keeps on the host, aside).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from tpudist import memory as jax_memory
from tpudist.parallel.plan import ParallelPlan as JPlan

from torch_composed import (
    assert_cli_close, assert_close, jax_model, lm_cli_reference,
    lm_geometry_flags, reference, spawn,
)
from torch_threads import two_torch_threads  # noqa: F401

V, S, B = 64, 16, 8
MESH = {"data": 1, "fsdp": 2, "tensor": 2, "min_size": 256}
GEOM = {"gpt2": dict(max_seq_len=S, hidden_dim=32, depth=2, num_heads=4),
        "llama": dict(max_seq_len=S, hidden_dim=32, depth=2, num_heads=4,
                      num_kv_heads=2, ffn_dim=64)}
CASES = {("gpt2", "sgd"): 1, ("gpt2", "adam"): 3, ("llama", "adam"): 3}
CLI_S, CLI_B, CLI_STEPS, CLI_LR = 32, 2, 3, 1e-3
CLI_GEOM = dict(max_seq_len=CLI_S, hidden_dim=32, depth=2, num_heads=4)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_fsdp")
    rng = np.random.Generator(np.random.PCG64(5))
    refs, cases = {}, {}
    for (arch, opt), steps in CASES.items():
        batches = [rng.integers(0, V, (B, S)).astype(np.int32)
                   for _ in range(steps)]
        tx = optax.sgd(0.1) if opt == "sgd" else optax.adam(1e-3)
        init, losses, final = reference(arch, tx, batches, mesh=MESH,
                                        vocab=V, geom=GEOM[arch])
        refs[(arch, opt)] = (losses, final)
        cases[f"{arch}-{opt}"] = {
            "arch": arch, "opt": opt, "attn": "xla", "zero1": False,
            "geom": GEOM[arch], "init": init,
            "batches": [torch.from_numpy(b) for b in batches]}
    # the batch rides data x fsdp: two replicas
    stream = rng.integers(0, V, CLI_STEPS * CLI_B * 2 * CLI_S).astype(
        np.uint16)
    stream.tofile(tmp / "tokens.bin")
    cli_mesh = {"data": 1, "fsdp": 2, "tensor": 2}
    cli_init, cli_losses, cli_final = lm_cli_reference(
        stream, mesh=cli_mesh, replicas=2, vocab=V, geom=CLI_GEOM,
        batch=CLI_B, seq=CLI_S, steps=CLI_STEPS, lr=CLI_LR)
    cli = [*lm_geometry_flags(V, CLI_GEOM), "--tokens",
           str(tmp / "tokens.bin"), "--lr", str(CLI_LR), "--warmup_steps",
           "0", "--total_steps", str(CLI_STEPS), "--no_profiler",
           "--batch_size", str(CLI_B), "--log_dir", str(tmp / "l"),
           "--checkpoint_dir", str(tmp / "cli_ck"), "--fsdp", "2"]
    got = spawn(tmp, {
        "V": V, "mesh": MESH, "cases": cases,
        "ckpt": ("gpt2-adam", str(tmp / "ck")), "cli_init": cli_init,
        "cli": [("cli", "tpudist_torch.train_gpt2",
                 [*cli, "--tensor", "2", "--attn", "vmem", "--fused", "all",
                  "--chunked_ce", "5", "--eval", "--generate", "4"]),
                ("resize", "tpudist_torch.train_gpt2",
                 [*cli, "--tensor", "4", "--fsdp", "1", "--epochs", "2"])]})
    return refs, (cli_losses, cli_final), got, tmp


@pytest.mark.parametrize("arch,opt", list(CASES), ids=lambda x: x)
def test_step_matches_the_references_plan(world, arch, opt):
    refs, _, got, _ = world
    assert got["worlds"] == {"data": 1, "fsdp": 2, "seq": 1, "tensor": 2}
    assert got["mesh_dims"] == ("fsdp", "tensor")
    for rank in range(4):
        r = got[(f"{arch}-{opt}", rank)]
        # FSDP2's module, no DDP
        assert r["module"] in ("FSDPGPT2", "FSDPLlama"), r["module"]
        assert_close(r, *refs[(arch, opt)], sgd=opt == "sgd")


def _reference_placements(arch):
    """The reference plan's placement of each leaf, by the port's names:
    ``"tensor"`` where its spec names the tensor axis, ``"fsdp"`` where it
    names fsdp, None where it is replicated; and its per-device bytes."""
    plan = JPlan.build(data=1, fsdp=2, tensor=2, fsdp_min_size=256,
                       devices=jax.devices()[:4])
    model, convert = jax_model(arch, V, GEOM[arch], "xla", plan.mesh)
    boxed = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
        train=False)["params"])
    shardings = plan.shardings(boxed)
    shapes = nn.meta.unbox(boxed)

    def mark(axis):
        return convert(jax.tree_util.tree_map(
            lambda s, sh: np.full(s.shape, float(any(
                axis in (p if isinstance(p, tuple) else (p,))
                for p in sh.spec if p is not None)), np.float32),
            shapes, shardings))

    tensor, fsdp = mark("tensor"), mark("fsdp")
    names = {k: ("tensor" if float(tensor[k].max()) == 1.0 else "fsdp"
                 if float(fsdp[k].max()) == 1.0 else None) for k in tensor}
    return names, jax_memory.per_device_bytes(shapes, shardings)


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_placements_and_bytes_are_the_reference_plans(world, arch):
    _, _, got, _ = world
    want, want_bytes = _reference_placements(arch)
    r = got[(f"{arch}-adam", 0)]
    assert r["placement"] == want
    assert r["param_bytes"] == want_bytes
    if arch == "gpt2":
        # the Megatron kernels over tensor, wpe over fsdp, the rest whole
        assert want["h.0.qkv.weight"] == "tensor" and want["wpe"] == "fsdp"
        assert want["h.0.ln_1.scale"] is None


def test_cli_matches_the_references_plan(world):
    _, (want_losses, want), got, _ = world
    for rank in range(4):
        r = got[("cli", rank)]
        assert "error" not in r, r.get("error")
        assert_cli_close(r, want_losses, want, steps=CLI_STEPS, lr=CLI_LR)
    out = got[("cli", 0)]["stdout"]
    assert "generated tokens: [" in out and "val_loss:" in out


def test_cli_checkpoint_records_the_plan_and_refuses_a_resize(world):
    import json

    from tpudist_torch.checkpoint import META_FILE

    _, _, got, tmp = world
    saved = json.loads((tmp / "cli_ck" / META_FILE).read_text())
    assert saved["fsdp_world"] == 2 and saved["tensor_world"] == 2
    for rank in range(4):
        err = got[("resize", rank)].get("error", "")
        assert "only the data axis is elastic" in err, err
        assert "MeshConfig(fsdp=2, tensor=2, pipe=1, expert=1)" in err, err


def test_checkpoint_under_the_plan_restores_bit_for_bit(world):
    _, _, got, _ = world
    assert all(got[("restored", r)] for r in range(4))
    shapes = got["saved_shapes"]
    # tensor shards and FSDP shards both at their whole shapes
    assert shapes["opt.mu.wte"] == (V, 32)
    assert shapes["params.h.0.qkv.weight"] == (96, 32)
    assert shapes["params.wpe"] == (S, 32)
    assert shapes["opt.nu.wpe"] == (S, 32)


def _budget_reference(arch, axes, zero1):
    from tpudist.optim import make_optimizer as jax_make_optimizer

    n = int(np.prod(list(axes.values())))
    plan = JPlan.build(devices=jax.devices()[:n], **axes)
    jtx = jax_make_optimizer(1e-3)
    if zero1:
        jtx = plan.wrap_zero1(jtx)
    model, _ = jax_model(arch, V, {**GEOM[arch], "max_seq_len": 32,
                                   "hidden_dim": 64}, "xla", None)
    return jax_memory.train_state_budget(
        model, jtx, jnp.zeros((1, 8), jnp.int32), batch=8, seq=32,
        plan=plan, hbm_budget_bytes=1 << 34)


@pytest.mark.parametrize("zero1", [False, True], ids=["adam", "zero1"])
@pytest.mark.parametrize("axes", [dict(data=2, fsdp=2, tensor=2),
                                  dict(data=1, fsdp=2, tensor=2)],
                         ids=["data2-fsdp2-tensor2", "fsdp2-tensor2"])
@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_budget_under_a_tensor_plan_is_the_references(arch, axes, zero1):
    from tpudist_torch import memory as M
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.models.llama import Llama
    from tpudist_torch.optim import make_optimizer, shard_state

    want = _budget_reference(arch, axes, zero1)
    tx = make_optimizer(1e-3)
    if zero1:
        tx = shard_state(tx, world=axes["data"], rank=0)
    cls = GPT2 if arch == "gpt2" else Llama
    got = M.train_state_budget(
        lambda d: cls(vocab_size=V, **{**GEOM[arch], "max_seq_len": 32,
                                       "hidden_dim": 64}, attn_impl="xla",
                      device=d),
        tx, batch=8, seq=32, plan=types.SimpleNamespace(**axes),
        hbm_budget_bytes=1 << 34)
    for k in ("params_bytes", "grad_bytes", "activation_bytes_est",
              "n_params", "params_bytes_global", "fsdp_world",
              "tensor_world", "plan"):
        assert got[k] == want[k], k
    count = 4  # the reference's int32 Adam count
    assert got["opt_state_bytes_per_chip"] == \
        want["opt_state_bytes_per_chip"] - count
    assert got["opt_state_bytes_global"] == \
        want["opt_state_bytes_global"] - count
