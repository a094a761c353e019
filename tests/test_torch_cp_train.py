"""Context-parallel training through the LM CLI (tpudist_torch.train_gpt2
``--cp N --attn ring|ulysses``) in gloo worlds on the CPU, against the
JAX reference's train step with the same ``attn_impl`` on its ``data x
seq`` mesh.

Each case launches ``train_gpt2.main`` as a world of 2 ranks (``--cp 2``)
or 4 (data 2 x seq 2) from one init: flax's, carried across by
``interop.gpt2_params_from_flax`` / ``llama_params_from_flax``. Three
steps of AdamW at lr 1e-4 (cosine over the 3 steps, no warmup) on the
windows the port's loader deals each data replica; the reference runs
``make_train_step`` with the CLI's ``batch_spec`` (tokens over ``(data,
seq)``, a leading replicated dim under ``--grad_accum``) on the global
batch those replicas make, on ``MeshConfig(data=dp, seq=cp)`` over the
first ``dp * cp`` of conftest.py's fake devices. GPT-2 and Llama with
GQA (4 query heads over 2 K/V heads), ring and Ulysses, with
``--grad_accum 2 --chunked_ce 8``, ``--remat full`` and ``--fused
optimizer`` among the cases. Every rank must log the reference's losses
within 2e-5 relative and end at its parameters within 1e-4 absolute
(float32 on both sides, summed in other orders); one process without CP
(``--attn xla``, the replicas' batches as one) must agree as well.
Then a run of five steps: the TSV and the ``tokens/sec`` line count data
replicas, not ranks, and the seq peers of a replica read the same
windows.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta
from jax.sharding import PartitionSpec as P

from tpudist import mesh as jax_mesh
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.models.llama import Llama as JLlama
from tpudist.models.lm_utils import chunked_lm_forward as jax_chunked
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.optim import run_schedule as jax_run_schedule
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import lm_loss as jax_lm_loss
from tpudist.train import make_train_step as jax_make_train_step
from tpudist.train import state_shardings_of
from tpudist_torch.data.lm import TokenWindowLoader
from tpudist_torch.interop import gpt2_params_from_flax, llama_params_from_flax
from tpudist_torch.models.gpt2 import GPT2 as GPT2T

REPO = Path(__file__).resolve().parent.parent
S, B, V, STEPS, LR = 32, 2, 64, 3, 1e-4
GEOM = dict(vocab_size=V, max_seq_len=S, hidden_dim=32, depth=2, num_heads=4)
LLAMA = dict(num_kv_heads=2, ffn_dim=64)

WORKER = """
import contextlib, io, os, sys, types
import torch
import tpudist_torch.data.lm as LM
import tpudist_torch.train_gpt2 as TG

out, init = sys.argv[1], sys.argv[2]
state_dict = torch.load(init)
build = TG.build_model

def build_loaded(*args, **kw):
    model = build(*args, **kw)
    model.load_state_dict(state_dict)
    return model

TG.build_model = build_loaded
windows, gather = [], LM.TokenWindowLoader.gather

def recording(self, indices):
    batch = gather(self, indices)
    windows.append(batch["tokens"].copy())
    return batch

LM.TokenWindowLoader.gather = recording
if os.environ.get("FIXED_WALL_S"):
    # the CLI's wall clock: its two readings 10 s apart
    ticks = iter([0.0, float(os.environ["FIXED_WALL_S"])])
    TG.time = types.SimpleNamespace(time=lambda: next(ticks))
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    state, losses = TG.main(["--device", "cpu", *sys.argv[3:]])
torch.save({"losses": losses, "params": state.params(), "windows": windows,
            "stdout": printed.getvalue()}, out)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, tag, world, argv, extra_env=None):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "1", **(extra_env or {})}
        out = tmp_path / f"{tag}_r{rank}.pt"
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", WORKER, str(out), str(tmp_path / "init.pt"),
             *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


def _collect(procs):
    try:
        results = []
        for out, proc in procs:
            log, _ = proc.communicate(timeout=120)
            assert proc.returncode == 0, log
            results.append(torch.load(out, weights_only=False))
        return results
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()


def _reference(arch, attn, dp, cp, grad_accum, chunk, remat, fused):
    """The reference's train step: returns ``(init, run)``, the initial
    parameters as the port's state dict and ``run(batches) -> (losses,
    final parameters as the port's)``."""
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(data=dp, seq=cp),
                                devices=jax.devices()[:dp * cp])
    if arch == "llama":
        model = JLlama(**GEOM, **LLAMA, attn_impl=attn, mesh=mesh)
        convert = llama_params_from_flax
    else:
        model = JGPT2(**GEOM, attn_impl=attn, mesh=mesh)
        convert = gpt2_params_from_flax
    tx = jax_make_optimizer(
        jax_run_schedule(LR, total_steps=STEPS, warmup_steps=0),
        weight_decay=0.1, clip_norm=1.0, fused=fused == "optimizer")
    state = jax_create_train_state(model, 0, jnp.zeros((B * dp, S), jnp.int32),
                                   tx, mesh)
    data = (jax_mesh.DATA_AXIS, jax_mesh.FSDP_AXIS)
    spec = (P(data, jax_mesh.SEQUENCE_AXIS) if grad_accum == 1
            else P(None, data, jax_mesh.SEQUENCE_AXIS))
    step = jax_make_train_step(
        model, tx, mesh, loss_fn=jax_lm_loss, input_key="tokens",
        label_key="tokens", grad_accum=grad_accum, remat=remat, fused=fused,
        forward_loss=jax_chunked(model, chunk=chunk) if chunk else None,
        state_sharding=state_shardings_of(state),
        batch_spec={"tokens": spec})

    def params(st):
        return convert(jax.tree_util.tree_map(np.asarray,
                                              meta.unbox(st.params)))

    def run(batches):
        st, losses = state, []
        for batch in batches:
            st, metrics = step(st, {"tokens": batch})
            losses.append(float(metrics["loss"]))
        return losses, params(st)

    return params(state), run


def _global_batches(stream, dp, grad_accum):
    """Each step's global batch as the reference takes it: microbatch-major,
    each microbatch the data replicas' rows in replica order, every
    replica's rows those the port's sampler deals it."""
    loaders = [iter(TokenWindowLoader(stream, B * grad_accum, S,
                                      num_replicas=dp, rank=d))
               for d in range(dp)]
    out = []
    for _ in range(STEPS):
        rows = [next(it)["tokens"] for it in loaders]
        out.append(np.concatenate([r[i * B:(i + 1) * B] for i in
                                   range(grad_accum) for r in rows]))
    return out


def _assert_params(got, want, what):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1e-4,
                                   rtol=0, err_msg=f"{what}: {k}")


CASES = [
    ("gpt2", "ring", 2, []),
    ("gpt2", "ulysses", 4, []),
    ("llama", "ring", 4, ["--remat", "full"]),
    ("llama", "ulysses", 2, ["--fused", "optimizer"]),
    ("gpt2", "ring", 4, ["--grad_accum", "2", "--chunked_ce", "8"]),
    ("llama", "ulysses", 4, ["--grad_accum", "2", "--chunked_ce", "8"]),
]


@pytest.mark.parametrize("arch,attn,world,extra", CASES,
                         ids=[f"{a}-{m}-w{w}{'-' if e else ''}"
                              f"{'-'.join(x.strip('-') for x in e)}"
                              for a, m, w, e in CASES])
def test_cp_training_matches_the_reference(arch, attn, world, extra,
                                           tmp_path):
    cp, grad_accum = 2, 2 if "--grad_accum" in extra else 1
    dp = world // cp
    chunk = 8 if "--chunked_ce" in extra else 0
    remat = "full" if "--remat" in extra else False
    fused = "optimizer" if "--fused" in extra else None
    rng = np.random.Generator(np.random.PCG64(7))
    stream = rng.integers(0, V, STEPS * B * dp * grad_accum * S).astype(
        np.uint16)
    stream.tofile(tmp_path / "tokens.bin")
    geom = ["--vocab_size", str(V), "--seq_len", str(S), "--hidden_dim",
            str(GEOM["hidden_dim"]), "--depth", str(GEOM["depth"]),
            "--num_heads", str(GEOM["num_heads"])]
    if arch == "llama":
        geom += ["--arch", "llama", "--num_kv_heads", str(LLAMA["num_kv_heads"]),
                 "--ffn_dim", str(LLAMA["ffn_dim"])]
    common = [*geom, "--tokens", str(tmp_path / "tokens.bin"), "--lr", str(LR),
              "--warmup_steps", "0", "--total_steps", str(STEPS),
              "--no_profiler", *extra]
    init, reference = _reference(arch, attn, dp, cp, grad_accum, chunk,
                                 remat, fused)
    torch.save(init, tmp_path / "init.pt")
    cp_run = _launch(tmp_path, "cp", world, [
        *common, "--cp", str(cp), "--attn", attn, "--batch_size", str(B),
        "--log_dir", str(tmp_path / "cp"), "--JobID", "CP"])
    flat_run = _launch(tmp_path, "flat", 1, [
        *common, "--attn", "xla", "--batch_size", str(B * dp),
        "--log_dir", str(tmp_path / "flat")])
    # the oracle while the worlds run
    want_losses, want = reference(_global_batches(stream, dp, grad_accum))
    ranks, (flat,) = _collect(cp_run), _collect(flat_run)

    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["losses"], want_losses, rtol=2e-5,
                                   err_msg=f"rank {rank}")
        _assert_params(r["params"], want, f"rank {rank}")
    np.testing.assert_allclose(flat["losses"], want_losses, rtol=2e-5)
    _assert_params(flat["params"], want, "one process without CP")


def test_replicas_are_counted_and_seq_peers_share_windows(tmp_path):
    """data 2 x seq 2, five steps: the TSV's g_step and g_img at step 5
    and the tokens/sec line (over a wall clock fixed at 10 s) count the 2
    data replicas; the seq peers of a replica read the same windows, the
    replicas others."""
    world, cp, dp, steps = 4, 2, 2, 5
    rng = np.random.Generator(np.random.PCG64(8))
    rng.integers(0, V, steps * B * dp * S).astype(np.uint16).tofile(
        tmp_path / "tokens.bin")
    model = GPT2T(**{**GEOM, "depth": 1}, device="cpu")
    torch.save(model.state_dict(), tmp_path / "init.pt")
    ranks = _collect(_launch(tmp_path, "cp", world, [
        "--vocab_size", str(V), "--seq_len", str(S), "--hidden_dim",
        str(GEOM["hidden_dim"]), "--depth", "1", "--num_heads",
        str(GEOM["num_heads"]), "--tokens", str(tmp_path / "tokens.bin"),
        "--no_profiler", "--cp", str(cp), "--attn", "ring", "--batch_size",
        str(B), "--log_dir", str(tmp_path), "--JobID", "CP"],
        extra_env={"FIXED_WALL_S": "10"}))
    for rank, r in enumerate(ranks):
        peer = ranks[rank ^ 1]
        assert len(r["windows"]) == steps
        assert all(np.array_equal(a, b) for a, b in
                   zip(r["windows"], peer["windows"], strict=True))
        other = ranks[(rank + cp) % world]
        assert not np.array_equal(r["windows"][0], other["windows"][0])
    rows = (tmp_path / f"CP_{B}_0.log").read_text().splitlines()
    step5 = rows[1].split("\t")
    assert (step5[1], step5[2]) == (str(5 * dp), str(5 * dp * B))
    assert rows[2].startswith("TrainTime\t") and len(rows) == 3
    want = steps * B * dp * S / 10.0
    assert (f"tokens/sec: {want:.1f} (global, incl. the first step) "
            f"steps={steps} ") in ranks[0]["stdout"]
    assert "tokens/sec" not in ranks[1]["stdout"]
