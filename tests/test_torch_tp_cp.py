"""Context parallelism composed with tensor parallelism (a layout of
``seq 2 x tensor 2``: ring, Ulysses and the gathered attention over the
seq group on the heads a tensor rank holds; ``train_gpt2 --cp 2 --tensor
2``, ``train_bert --tensor 2 --cp 2``) against the JAX package's step on
``MeshConfig(seq=2, tensor=2)`` over 4 CPU devices, in one gloo world of
4 ranks.

- GPT-2 (ring, Ulysses, the gathered dense attention) and GQA Llama
  (Ulysses; its K/V heads repeated first) at V 64, 2 layers, width 32:
  one SGD step within ``atol=rtol=1e-5`` and three Adam steps within
  ``rtol 2e-4`` of the reference's step (tests/test_parallel_plan.py's
  bars). The CE is counted once: the loss is the chunk's vocabulary-
  parallel CE sum over the replica's positions, the backward runs on it
  times seq, and the gradients are averaged over the ranks of a tensor
  index.
- The Ulysses heads gather: GPT-2 at 6 heads (width 48), so a rank's 3
  heads do not divide over the seq group of 2, which the reference's
  check (``num_heads % seq``) allows: q, k and v are gathered over the
  tensor group around the exchange.
- ``train_gpt2 --cp 2 --tensor 2 --attn ulysses`` against the
  reference's step with the CLI's schedule; ``train_bert --tensor 2 --cp
  2 --attn ulysses --chunked_ce 5`` against the reference's BERT step
  over the batches the ranks corrupted (the MLM denominator the global
  masked count, counted once over the seq group and not again over
  tensor).
- A DCP checkpoint under ``seq 2 x tensor 2`` restores bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta
from jax.sharding import PartitionSpec as P

from tpudist import mesh as jax_mesh
from tpudist.models import bert as JB
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.optim import run_schedule as jax_run_schedule
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import make_train_step as jax_make_train_step
from tpudist.train import state_shardings_of
from tpudist_torch.interop import bert_params_from_flax

from torch_composed import (
    assert_cli_close, assert_close, lm_cli_reference, lm_geometry_flags,
    reference, spawn,
)
from torch_threads import two_torch_threads  # noqa: F401

V, S, B = 64, 16, 8
MESH = {"data": 1, "seq": 2, "tensor": 2}
GEOM = {"gpt2": dict(max_seq_len=S, hidden_dim=32, depth=2, num_heads=4),
        "gpt2-6": dict(max_seq_len=S, hidden_dim=48, depth=2, num_heads=6),
        "llama": dict(max_seq_len=S, hidden_dim=32, depth=2, num_heads=4,
                      num_kv_heads=2, ffn_dim=64)}
#: name -> (arch, geometry, attention, optimizer, steps)
CASES = {
    "gpt2-ring-sgd": ("gpt2", "gpt2", "ring", "sgd", 1),
    "gpt2-ring": ("gpt2", "gpt2", "ring", "adam", 3),
    "gpt2-ulysses": ("gpt2", "gpt2", "ulysses", "adam", 3),
    "gpt2-gathered": ("gpt2", "gpt2", "xla", "adam", 3),
    "llama-ulysses": ("llama", "llama", "ulysses", "adam", 3),
    "gpt2-6heads-ulysses": ("gpt2", "gpt2-6", "ulysses", "adam", 3),
}
CLI_S, CLI_B, CLI_STEPS, CLI_LR = 32, 2, 3, 1e-3
CLI_GEOM = dict(max_seq_len=CLI_S, hidden_dim=32, depth=2, num_heads=4)
BERT_GEOM = dict(max_seq_len=CLI_S, hidden_dim=32, depth=2, num_heads=4)
BERT_B = 4
KEYS = ("tokens", "targets", "mlm_mask")


def _bert_reference(batches):
    """The reference's BERT step (the CLI's schedule) on the seq x tensor
    mesh, the tokens, targets and mask sharded over ``((data, fsdp),
    seq)`` as examples/train_bert.py shards them: ``(init, losses,
    final)``."""
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(**MESH),
                                devices=jax.devices()[:4])
    jm = JB.Bert(vocab_size=64, **BERT_GEOM, attn_impl="ulysses", mesh=mesh)
    tx = jax_make_optimizer(jax_run_schedule(CLI_LR, total_steps=CLI_STEPS,
                                             warmup_steps=0))
    state = jax_create_train_state(jm, 1, jnp.zeros((1, CLI_S), jnp.int32),
                                   tx, mesh)
    spec = P((jax_mesh.DATA_AXIS, jax_mesh.FSDP_AXIS),
             jax_mesh.SEQUENCE_AXIS)
    step = jax_make_train_step(jm, tx, mesh, input_key="tokens",
                               label_key="targets",
                               forward_loss=JB.mlm_forward(jm, chunk=5),
                               state_sharding=state_shardings_of(state),
                               batch_spec={k: spec for k in KEYS})
    unbox = lambda st: bert_params_from_flax(jax.tree_util.tree_map(
        np.asarray, meta.unbox(st.params)))
    init, losses = unbox(state), []
    for b in batches:
        state, m = step(state, {k: np.asarray(b[k]) for k in KEYS})
        losses.append(float(m["loss"]))
    return init, losses, unbox(state)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_cp")
    rng = np.random.Generator(np.random.PCG64(9))
    refs, cases = {}, {}
    for name, (arch, geom, attn, opt, steps) in CASES.items():
        batches = [rng.integers(0, V, (B, S)).astype(np.int32)
                   for _ in range(steps)]
        tx = optax.sgd(0.1) if opt == "sgd" else optax.adam(1e-3)
        init, losses, final = reference(arch, tx, batches, mesh=MESH,
                                        vocab=V, geom=GEOM[geom], attn=attn)
        refs[name] = (losses, final)
        cases[name] = {"arch": arch, "opt": opt, "attn": attn,
                       "zero1": False, "geom": GEOM[geom], "init": init,
                       "batches": [torch.from_numpy(b) for b in batches]}
    stream = rng.integers(0, V, CLI_STEPS * CLI_B * CLI_S).astype(np.uint16)
    stream.tofile(tmp / "tokens.bin")
    cli_init, cli_losses, cli_final = lm_cli_reference(
        stream, mesh=MESH, replicas=1, vocab=V, geom=CLI_GEOM, batch=CLI_B,
        seq=CLI_S, steps=CLI_STEPS, lr=CLI_LR, attn="ulysses")
    rng.integers(0, 64, CLI_STEPS * BERT_B * CLI_S).astype(
        np.uint16).tofile(tmp / "bert.bin")
    bert_init = _bert_reference([])[0]
    got = spawn(tmp, {
        "V": V, "mesh": MESH, "cases": cases,
        "ckpt": ("gpt2-ring", str(tmp / "ck")), "cli_init": cli_init,
        "cli": [("cli", "tpudist_torch.train_gpt2",
                 [*lm_geometry_flags(V, CLI_GEOM), "--tokens",
                  str(tmp / "tokens.bin"), "--lr", str(CLI_LR),
                  "--warmup_steps", "0", "--total_steps", str(CLI_STEPS),
                  "--no_profiler", "--batch_size", str(CLI_B), "--log_dir",
                  str(tmp / "l"), "--cp", "2", "--tensor", "2", "--attn",
                  "ulysses"]),
                ("bert", "tpudist_torch.train_bert",
                 ["--seq_len", str(CLI_S), "--hidden_dim", "32", "--depth",
                  "2", "--num_heads", "4", "--no_profiler", "--tensor", "2",
                  "--cp", "2", "--attn", "ulysses", "--vocab_size", "64",
                  "--mask_id", "63", "--tokens", str(tmp / "bert.bin"),
                  "--batch_size", str(BERT_B), "--lr", str(CLI_LR),
                  "--chunked_ce", "5", "--log_dir", str(tmp / "b")],
                 bert_init)]})
    return refs, (cli_losses, cli_final), got


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_the_references_seq_x_tensor_mesh(world, name):
    refs, _, got = world
    assert got["worlds"] == {"data": 1, "fsdp": 1, "seq": 2, "tensor": 2}
    assert got["mesh_dims"] == ("seq", "tensor")
    for rank in range(4):
        r = got[(name, rank)]
        # DDP over the seq ranks of a tensor index
        assert r["module"] == "DistributedDataParallel"
        assert_close(r, *refs[name], sgd=CASES[name][3] == "sgd")


def test_ulysses_gathers_heads_that_do_not_divide_over_seq():
    """At 6 heads over ``tensor 2 x seq 2`` a rank's 3 heads do not divide
    over the seq group: the attention runs on the heads gathered over the
    tensor group (the GPT-2 case above holds it to the reference), and the
    4-head geometry does not gather."""
    for geom, gathers in (("gpt2-6", True), ("gpt2", False)):
        local = GEOM[geom]["num_heads"] // MESH["tensor"]
        assert (local % MESH["seq"] != 0) == gathers
        assert GEOM[geom]["num_heads"] % MESH["seq"] == 0


def test_cli_matches_the_references_step(world):
    _, (want_losses, want), got = world
    for rank in range(4):
        r = got[("cli", rank)]
        assert "error" not in r, r.get("error")
        assert_cli_close(r, want_losses, want, steps=CLI_STEPS, lr=CLI_LR)


def test_bert_cli_matches_the_references_step(world):
    _, _, bert = world
    # each rank's first gather is fit's one-row probe; then the steps, the
    # same rows on every rank of the one replica
    batches = bert[("bert", 0)]["batches"][1:1 + CLI_STEPS]
    for rank in range(1, 4):
        for a, b in zip(batches, bert[("bert", rank)]["batches"][1:]):
            assert all(torch.equal(a[k], b[k]) for k in KEYS)
    init, want_losses, want = _bert_reference(batches)
    for rank in range(4):
        r = bert[("bert", rank)]
        assert "error" not in r, r.get("error")
        np.testing.assert_allclose(r["losses"], want_losses, rtol=2e-4)
    params = bert[("bert", 0)]["params"]
    assert params.keys() == want.keys()
    for k, w in want.items():
        g, w = params[k].numpy(), w.numpy()
        if k.endswith("qkv.bias"):
            moved = np.abs(g[1] - init[k].numpy()[1])
            assert moved.max() <= 1.5 * CLI_STEPS * CLI_LR, k
            g, w = g[[0, 2]], w[[0, 2]]
        np.testing.assert_allclose(g, w, rtol=2e-4,
                                   atol=2e-4 * CLI_LR * CLI_STEPS, err_msg=k)


def test_checkpoint_under_seq_x_tensor_restores_bit_for_bit(world):
    _, _, got = world
    assert all(got[("restored", r)] for r in range(4))
    shapes = got["saved_shapes"]
    assert shapes["opt.mu.wte"] == (V, 32)
    assert shapes["params.h.0.qkv.weight"] == (96, 32)
