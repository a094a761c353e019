"""ZeRO-1 composed with tensor parallelism (``shard_state`` over a ``data 2
x tensor 2`` layout, ``train_gpt2 --tensor 2 --shard_opt_state``) and the
plan's ``(fsdp, data)`` overlay on ``data 2 x fsdp 2``, against the JAX
package's ``shard_state`` / ``plan.wrap_zero1`` on the same meshes of 4
CPU devices, in one gloo world of 4 ranks.

- GPT-2 and GQA Llama (V 64, 2 layers, width 32): one SGD step within
  ``atol=rtol=1e-5`` and three Adam steps within ``rtol 2e-4`` of the
  reference's ZeRO-1 step (tests/test_parallel_plan.py's bars); Adam and
  the fused AdamW under ZeRO-1 bit-equal to the port's replicated step
  (tests/test_torch_zero1.py's bar).
- A rank slices the moments of its own tensor shard over its data group.
  The reference slices a tensor-placed leaf's whole mirror over data and
  replicates the slices over tensor, so the port holds fewer bytes; the
  budget test states both figures and the formula of the difference.
- The overlay: under ``data 2 x fsdp 2`` a leaf FSDP shards on a dim
  ``fsdp x data`` divides has its moments sliced again over data, as the
  reference's ``_mirror_overlay`` places them; the step matches its plan.
- ``train_gpt2 --tensor 2 --shard_opt_state --fused all --chunked_ce 5``
  against the reference's step with the CLI's schedule.
- A DCP checkpoint of the ZeRO-1 state under tensor holds each moment at
  its whole shape and restores bit for bit.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpudist import memory as jax_memory
from tpudist.parallel.plan import ParallelPlan as JPlan

from torch_composed import (
    assert_cli_close, assert_close, jax_model, lm_cli_reference,
    lm_geometry_flags, reference, spawn,
)
from torch_threads import two_torch_threads  # noqa: F401

V, S, B = 64, 16, 8
MESH = {"data": 2, "tensor": 2}
OVERLAY_MESH = {"data": 2, "fsdp": 2, "min_size": 256}
GEOM = {"gpt2": dict(max_seq_len=S, hidden_dim=32, depth=2, num_heads=4),
        "llama": dict(max_seq_len=S, hidden_dim=32, depth=2, num_heads=4,
                      num_kv_heads=2, ffn_dim=64)}
#: name -> (arch, optimizer, ZeRO-1, steps)
CASES = {
    "gpt2-sgd-zero1": ("gpt2", "sgd", True, 1),
    "gpt2-adam-zero1": ("gpt2", "adam", True, 3),
    "gpt2-adam": ("gpt2", "adam", False, 3),
    "gpt2-fused-zero1": ("gpt2", "fused", True, 3),
    "gpt2-fused": ("gpt2", "fused", False, 3),
    "llama-adam-zero1": ("llama", "adam", True, 3),
    "llama-adam": ("llama", "adam", False, 3),
}
CLI_S, CLI_B, CLI_STEPS, CLI_LR = 32, 2, 3, 1e-3
CLI_GEOM = dict(max_seq_len=CLI_S, hidden_dim=32, depth=2, num_heads=4)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_zero1")
    # the batches of tests/test_torch_tp_train.py, drawn in its order, so
    # that ZeRO-1 is held where the replicated data x tensor step is
    rng = np.random.Generator(np.random.PCG64(11))
    batches = {key: [rng.integers(0, V, (B, S)).astype(np.int32)
                     for _ in range(steps)]
               for key, steps in (("gpt2-sgd", 1), ("gpt2-adam", 3),
                                  ("llama-adam", 3))}
    refs, cases = {}, {}
    for name, (arch, opt, zero1, steps) in CASES.items():
        bs = batches[f"{arch}-{'sgd' if opt == 'sgd' else 'adam'}"]
        tx = optax.sgd(0.1) if opt == "sgd" else optax.adam(1e-3)
        init, losses, final = reference(arch, tx, bs, mesh=MESH, vocab=V,
                                        geom=GEOM[arch], zero1=zero1)
        refs[name] = (losses, final)
        cases[name] = {"arch": arch, "opt": opt, "attn": "xla",
                       "zero1": zero1, "geom": GEOM[arch], "init": init,
                       "batches": [torch.from_numpy(b) for b in bs]}
    init, losses, final = reference(
        "gpt2", optax.adam(1e-3), batches["gpt2-adam"], mesh=OVERLAY_MESH,
        vocab=V, geom=GEOM["gpt2"], zero1=True)
    refs["overlay"] = (losses, final)
    overlay = {**cases["gpt2-adam-zero1"], "init": init,
               "mesh": OVERLAY_MESH}
    stream = rng.integers(0, V, CLI_STEPS * CLI_B * 2 * CLI_S).astype(
        np.uint16)
    stream.tofile(tmp / "tokens.bin")
    cli_init, cli_losses, cli_final = lm_cli_reference(
        stream, mesh=MESH, replicas=2, vocab=V, geom=CLI_GEOM, batch=CLI_B,
        seq=CLI_S, steps=CLI_STEPS, lr=CLI_LR)
    got = spawn(tmp, {
        "V": V, "mesh": MESH, "cases": cases, "overlay": overlay,
        "ckpt": ("gpt2-adam-zero1", str(tmp / "ck")), "cli_init": cli_init,
        "cli": [("cli", "tpudist_torch.train_gpt2",
                 [*lm_geometry_flags(V, CLI_GEOM), "--tokens",
                  str(tmp / "tokens.bin"), "--lr", str(CLI_LR),
                  "--warmup_steps", "0", "--total_steps", str(CLI_STEPS),
                  "--no_profiler", "--batch_size", str(CLI_B), "--log_dir",
                  str(tmp / "l"), "--tensor", "2", "--shard_opt_state",
                  "--fused", "all", "--chunked_ce", "5", "--attn", "vmem"])]})
    return refs, (cli_losses, cli_final), got


@pytest.mark.parametrize("name", [k for k, c in CASES.items() if c[2]])
def test_zero1_step_matches_the_reference(world, name):
    refs, _, got = world
    assert got["worlds"] == {"data": 2, "fsdp": 1, "seq": 1, "tensor": 2}
    for rank in range(4):
        assert_close(got[(name, rank)], *refs[name],
                     sgd=CASES[name][1] == "sgd")


@pytest.mark.parametrize("name", ["gpt2-adam", "gpt2-fused", "llama-adam"])
def test_zero1_is_bit_equal_to_the_replicated_step(world, name):
    _, _, got = world
    for rank in range(4):
        a, b = got[(name + "-zero1", rank)], got[(name, rank)]
        assert a["losses"] == b["losses"]
        for k, p in b["params"].items():
            assert torch.equal(a["params"][k], p), k


def test_a_rank_slices_its_tensor_shards_moments(world):
    _, _, got = world
    moments = got[("gpt2-adam-zero1", 0)]["moments"]["mu"]
    whole = got[("gpt2-adam", 0)]["moments"]["mu"]
    # qkv.weight: the rank's [48, 32] shard, its largest dim halved over
    # data; wte: its [32, 32] vocabulary rows, the last of equal dims
    # halved; the LayerNorms (under ZeRO-1's threshold) whole
    assert whole["h.0.qkv.weight"] == (48, 32)
    assert moments["h.0.qkv.weight"] == (24, 32)
    assert moments["wte"] == (32, 16)
    assert moments["h.0.ln_1.scale"] == (32,)


def test_overlay_slices_fsdp_shards_over_data(world):
    refs, _, got = world
    for rank in range(4):
        r = got[("overlay", rank)]
        assert_close(r, *refs["overlay"], sgd=False)
        # wte [64, 32]: FSDP's [32, 32] shard, its moments [16, 32], a
        # quarter (the reference's P(('fsdp', 'data'), None)); wpe [16, 32]
        # on its dim 1
        assert r["placement"]["wte"] == "fsdp"
        assert r["modes"]["wte"] == "shard" and r["modes"]["wpe"] == "shard"
        assert r["moments"]["mu"]["wte"] == (16, 32)
        assert r["moments"]["mu"]["wpe"] == (16, 8)


def test_cli_matches_the_reference(world):
    _, (want_losses, want), got = world
    for rank in range(4):
        r = got[("cli", rank)]
        assert "error" not in r, r.get("error")
        assert_cli_close(r, want_losses, want, steps=CLI_STEPS, lr=CLI_LR)


def test_checkpoint_holds_whole_moments_and_restores(world):
    _, _, got = world
    assert all(got[("restored", r)] for r in range(4))
    shapes = got["saved_shapes"]
    assert shapes["opt.mu.h.0.qkv.weight"] == (96, 32), sorted(shapes)
    assert shapes["opt.nu.wte"] == (V, 32)


def _zero1_elems(shape, data, min_size=1024):
    """Elements a rank stores of one ZeRO-1 leaf of ``shape``."""
    from tpudist_torch.optim import _zero1_layout

    mode, info = _zero1_layout(tuple(shape), data, min_size)
    if mode == "shard":
        return math.prod(shape) // data
    if mode == "pad":
        return info
    return math.prod(shape)


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_budget_states_the_zero1_difference_by_formula(arch):
    """``train_state_budget(plan=)`` under ``data 2 x tensor 2`` with
    ZeRO-1. Parameters, gradients and activations are the reference's.
    The optimizer state differs by the tensor-placed leaves alone: the
    reference stores Adam's two moments of each such leaf that ZeRO-1
    slices as its whole shape's slice (replicated over tensor; a leaf
    under ZeRO-1's threshold keeps its tensor shard), the port as the
    ZeRO-1 slice of the rank's tensor shard, so ``reference - port =
    count + sum over those leaves of 2 x 4 bytes x (ref(leaf) -
    zero1(shard))`` with ``ref(leaf) = zero1(whole)`` where ZeRO-1 slices
    the whole leaf and ``shard`` elsewhere, ``count`` the reference's
    int32 Adam count."""
    from tpudist.optim import make_optimizer as jax_make_optimizer
    from tpudist_torch import memory as M
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.models.llama import Llama
    from tpudist_torch.optim import make_optimizer, shard_state
    from tpudist_torch.parallel import tp

    geom = {**GEOM[arch], "max_seq_len": 32, "hidden_dim": 64}
    plan = JPlan.build(data=2, tensor=2, devices=jax.devices()[:4])
    model, _ = jax_model(arch, V, geom, "xla", None)
    want = jax_memory.train_state_budget(
        model, plan.wrap_zero1(jax_make_optimizer(1e-3)),
        jnp.zeros((1, 8), jnp.int32), batch=8, seq=32, plan=plan,
        hbm_budget_bytes=1 << 34)
    cls = GPT2 if arch == "gpt2" else Llama
    whole = cls(vocab_size=V, **geom, device="meta")
    got = M.train_state_budget(
        lambda d: cls(vocab_size=V, **geom, attn_impl="xla", device=d),
        shard_state(make_optimizer(1e-3), world=2, rank=0), batch=8,
        seq=32, plan=types.SimpleNamespace(data=2, tensor=2),
        hbm_budget_bytes=1 << 34)
    for k in ("params_bytes", "grad_bytes", "activation_bytes_est",
              "n_params", "tensor_world"):
        assert got[k] == want[k], k
    diff = 0
    for k, p in whole.named_parameters():
        spec = tp.tensor_spec(k, table=whole.tensor_specs)
        if spec is None:
            continue
        shard = list(p.shape)
        dim = 0 if spec[0] == "vocab" else spec[0]
        shard[dim] = -(-shard[dim] // 2)
        sliced = _zero1_elems(p.shape, 2) < p.numel()
        ref = _zero1_elems(p.shape, 2) if sliced else math.prod(shard)
        diff += 2 * 4 * (ref - _zero1_elems(shard, 2))
    assert diff > 0
    count = 4
    assert got["opt_state_bytes_per_chip"] == \
        want["opt_state_bytes_per_chip"] - count - diff, (
            got["opt_state_bytes_per_chip"], want["opt_state_bytes_per_chip"])
