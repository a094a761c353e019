"""BERT training through the port (tpudist_torch.train_bert, mlm_forward
in make_train_step) against the JAX reference, on the CPU.

- Gloo worlds of 2 ranks launching ``train_bert.main``: two data replicas
  whose corruptions mask different numbers of positions (the MLM loss's
  denominator is the GLOBAL count of masked positions, not a mean of the
  ranks' means), the same with ``--grad_accum 2 --chunked_ce 8``, and
  ``--cp 2`` with ``--attn ring`` and ``ulysses`` (each rank its chunk of
  every row, bidirectional). The reference runs ``make_train_step`` with
  its ``mlm_forward`` and the CLI's ``batch_spec`` on ``MeshConfig(data,
  seq)`` over the global batch the port's ranks corrupted (recorded by the
  worker), from the same flax init. Every rank must log the reference's
  losses within 2e-5 relative and end at its parameters within 1e-4
  absolute (float32, summed in other orders), as tests/test_torch_cp_train.py.
- The CLI in one process against ``examples/train_bert.main`` (8
  emulated devices, a sequence each) from one ``--init_hf`` checkpoint the
  test writes: the losses (1e-5 relative), the TSV rows, the parameters
  (1e-4) and ``--eval``'s masked loss and accuracy (2e-4, against the
  reference's ``evaluate_mlm`` over the port's eval batch), full head and
  chunked.
- The model API with everything fused (the LN kernels' plain versions,
  vmem attention, fused AdamW) against the reference's fused step.
- The CLI's refusals.
"""

import contextlib
import io
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta
from jax.sharding import PartitionSpec as P

from tpudist import mesh as jax_mesh
from tpudist.models import bert as J
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.optim import run_schedule as jax_run_schedule
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import make_train_step as jax_make_train_step
from tpudist.train import state_shardings_of
from tpudist_torch import interop
from tpudist_torch.data.lm import encode_bytes
from tpudist_torch.models import bert as T
from tpudist_torch.optim import make_optimizer, run_schedule
from tpudist_torch.train import create_train_state, make_train_step
from tpudist_torch.train_bert import main

REPO = Path(__file__).resolve().parent.parent
S, B, V, STEPS, LR = 32, 2, 64, 3, 1e-3
GEOM = dict(max_seq_len=S, hidden_dim=32, depth=2, num_heads=4)
FLAGS = ["--seq_len", str(S), "--hidden_dim", "32", "--depth", "2",
         "--num_heads", "4", "--no_profiler"]
TEXT = b"the quick brown fox jumps over the lazy dog. " * 80

WORKER = """
import contextlib, io, sys
import torch
import tpudist_torch.data.lm as LM
import tpudist_torch.models.bert as MB
import tpudist_torch.train_bert as TB

out, init = sys.argv[1], sys.argv[2]
state_dict = torch.load(init)
Bert = MB.Bert

def loaded(*args, **kw):
    model = Bert(*args, **kw)
    model.load_state_dict(state_dict)
    return model

MB.Bert = loaded
batches, gather = [], LM.TokenWindowLoader._gather_batch

def recording(self, indices, start):
    batch = gather(self, indices, start)
    batches.append({k: v.copy() for k, v in batch.items()})
    return batch

LM.TokenWindowLoader._gather_batch = recording
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    state, losses = TB.main(["--device", "cpu", *sys.argv[3:]])
torch.save({"losses": losses, "params": state.params(), "batches": batches,
            "stdout": printed.getvalue()}, out)
"""


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    from torch_ports import free_port

    return free_port()


def _launch(tmp_path, world, argv):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "1"}
        out = tmp_path / f"r{rank}.pt"
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", WORKER, str(out), str(tmp_path / "init.pt"),
             *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _assert_params(got, want, what, start, steps, lr):
    """Within 1e-4 absolute, except the key slice of each qkv bias: its
    gradient is zero in exact arithmetic (q.b_k shifts a whole row of
    scores), so Adam turns each side's rounding noise into a step of
    either sign; it is held to the step bound 1.5 x steps x lr from its
    start (tests/test_torch_gpt2_train.py's rule)."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        if k.endswith("qkv.bias"):
            moved = np.abs(np.stack([g[1], w[1]]) - start[k].numpy()[1])
            assert moved.max() <= 1.5 * steps * lr, f"{what}: {k}"
            g, w = g[[0, 2]], w[[0, 2]]
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0,
                                   err_msg=f"{what}: {k}")


KEYS = ("tokens", "targets", "mlm_mask")
CASES = [("dp2", 2, 1, "xla", []),
         ("dp2-accum-chunked", 2, 1, "xla",
          ["--grad_accum", "2", "--chunked_ce", "8"]),
         ("cp2-ring", 1, 2, "ring", []),
         ("cp2-ulysses", 1, 2, "ulysses", [])]


@pytest.mark.parametrize("dp,cp,attn,extra", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_ranks_train_on_the_global_mlm_loss(dp, cp, attn, extra, tmp_path):
    grad_accum = 2 if "--grad_accum" in extra else 1
    chunk = 8 if "--chunked_ce" in extra else None
    rng = np.random.Generator(np.random.PCG64(5))
    rng.integers(0, V, STEPS * B * dp * grad_accum * S).astype(
        np.uint16).tofile(tmp_path / "tokens.bin")
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(data=dp, seq=cp),
                                devices=jax.devices()[:dp * cp])
    jm = J.Bert(vocab_size=V + 1, **GEOM, attn_impl=attn, mesh=mesh)
    tx = jax_make_optimizer(jax_run_schedule(LR, total_steps=STEPS,
                                             warmup_steps=0))
    state = jax_create_train_state(jm, 0, jnp.zeros((B * dp, S), jnp.int32),
                                   tx, mesh)
    init = interop.bert_params_from_flax(_np_tree(state.params))
    torch.save(init, tmp_path / "init.pt")
    ranks = _launch(tmp_path, dp * cp, [
        *FLAGS, "--vocab_size", str(V), "--tokens", str(tmp_path / "tokens.bin"),
        "--batch_size", str(B), "--lr", str(LR), "--cp", str(cp), "--attn",
        attn, "--log_dir", str(tmp_path), *extra])

    bd = (jax_mesh.DATA_AXIS, jax_mesh.FSDP_AXIS)
    spec = (P(bd, jax_mesh.SEQUENCE_AXIS) if grad_accum == 1
            else P(None, bd, jax_mesh.SEQUENCE_AXIS))
    step = jax_make_train_step(
        jm, tx, mesh, input_key="tokens", label_key="targets",
        grad_accum=grad_accum, forward_loss=J.mlm_forward(jm, chunk=chunk),
        state_sharding=state_shardings_of(state),
        batch_spec={k: spec for k in KEYS})
    want_losses, unequal, mean_of_means = [], 0, []
    # each rank's first gather is fit's one-row probe
    replicas = [ranks[d * cp]["batches"][1:] for d in range(dp)]
    for i in range(STEPS):
        # microbatch-major: each microbatch the replicas' rows in order
        rows = [r[i] for r in replicas]
        batch = {k: np.concatenate([r[k][m * B:(m + 1) * B]
                                    for m in range(grad_accum) for r in rows])
                 for k in KEYS}
        state, metrics = step(state, batch)
        want_losses.append(float(metrics["loss"]))
        counts = [int(r["mlm_mask"].sum()) for r in rows]
        unequal += len(set(counts)) > 1
    want = interop.bert_params_from_flax(_np_tree(state.params))
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["losses"], want_losses, rtol=2e-5,
                                   err_msg=f"rank {rank}")
        _assert_params(r["params"], want, f"rank {rank}", init, STEPS, LR)
    if cp > 1:  # the seq peers corrupt their replica's rows alike
        for a, b in zip(ranks[0]["batches"], ranks[1]["batches"], strict=True):
            for k in KEYS:
                np.testing.assert_array_equal(a[k], b[k])
    else:
        assert unequal  # the case the global denominator is for


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Byte tokens for six steps of 8 windows and a held-out stream, and an
    HF-layout BERT checkpoint (vocab 256, [MASK] 255) the port writes."""
    root = tmp_path_factory.mktemp("bert")
    tokens = encode_bytes(TEXT)
    tokens[:6 * 8 * S].astype(np.uint16).tofile(root / "train.bin")
    tokens[2000:2000 + 5 * S].astype(np.uint16).tofile(root / "val.bin")
    model = T.Bert(vocab_size=256, **GEOM, device="cpu", seed=9)
    interop.save_hf_checkpoint(model.state_dict(), root / "hf", arch="bert",
                               depth=2)
    return root


def _reference_module():
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import train_bert as ref
    finally:
        sys.path.pop(0)
    return ref


def _reference_cli(argv):
    ref = _reference_module()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state, losses = ref.main([*FLAGS, *argv])
    return state, losses, out.getvalue()


def _port_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state, losses = main([*FLAGS, "--device", "cpu", *argv])
    return state, losses, out.getvalue()


def _metric(text, name):
    return float(text.split(f"{name}: ")[1].split()[0])


def _rows(path):
    """(g_img, loss) of the TSV's rows."""
    lines = path.read_text().splitlines()
    assert lines[0] == "datetime\tg_step\tg_img\tloss_value\texamples_per_sec"
    assert lines[-1].startswith("TrainTime\t")
    return [(int(f[2]), float(f[3])) for f in
            (line.split("\t") for line in lines[1:-1])]


@pytest.mark.parametrize("chunk", ["0", "16"], ids=["full", "chunked"])
def test_cli_matches_the_reference_cli(chunk, corpus, tmp_path):
    """Six Adam steps from the same ``--init_hf`` checkpoint on the same
    windows and corruption (one process corrupts all 8 rows with seed 0 on
    both sides), then ``--eval``."""
    flags = ["--tokens", str(corpus / "train.bin"), "--val_tokens",
             str(corpus / "val.bin"), "--vocab_size", "256", "--mask_id",
             "255", "--init_hf", str(corpus / "hf"), "--lr", "1e-3",
             "--chunked_ce", chunk, "--eval"]
    jstate, want_losses, want_out = _reference_cli(
        [*flags, "--batch_size", "1", "--log_dir", str(tmp_path / "ref")])
    state, losses, out = _port_cli(
        [*flags, "--batch_size", "8", "--log_dir", str(tmp_path / "port")])
    assert len(losses) == len(want_losses) == 6
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got_rows = _rows(tmp_path / "port" / "Bert0_8_0.log")
    want_rows = _rows(tmp_path / "ref" / "Bert0_1_0.log")
    assert [g for g, _ in got_rows] == [g for g, _ in want_rows]
    np.testing.assert_allclose([v for _, v in got_rows],
                               [v for _, v in want_rows], rtol=1e-5)
    _assert_params(state.params(), interop.bert_params_from_flax(
        _np_tree(jstate.params)), "cli", interop.load_hf_params(
            corpus / "hf", arch="bert", depth=2, num_heads=4), 6, 1e-3)
    assert "tokens/sec: " in out and "steps=6 " in out
    # --eval: the reference's loader batch is its per-process --batch_size
    # (1 here), and its corruption a stream drawn batch by batch, so its
    # printed metrics are of other draws; the port's are held to the
    # reference's evaluate_mlm over the port's batch (the 5 held-out
    # windows in one batch of 8)
    ref = _reference_module()
    mesh = jax_mesh.create_mesh()  # the CLI's 8 devices, as jstate
    source = np.fromfile(corpus / "val.bin", np.uint16)
    args = types.SimpleNamespace(batch_size=8, seq_len=S, vocab_size=256,
                                 chunked_ce=int(chunk))
    want = ref.evaluate_mlm(J.Bert(vocab_size=256, **GEOM), jstate, source,
                            args, mesh, corruption=J.mlm_transform(
                                256, 255, seed=10_000))
    np.testing.assert_allclose(_metric(out, "mlm_loss"), want["loss"],
                               atol=2e-4)
    np.testing.assert_allclose(_metric(out, "masked_accuracy"),
                               want["accuracy"], atol=2e-4)


def test_model_api_fused_all_matches_the_reference(tmp_path):
    """``make_train_step(fused="all")`` with the fused AdamW, vmem
    attention and the chunked MLM head, three steps (the kernels' plain
    versions here, the Pallas kernels in interpret mode on the reference's
    side): losses 1e-5 relative, parameters 1e-4."""
    rng = np.random.Generator(np.random.PCG64(6))
    tr = J.mlm_transform(V + 1, V, seed=2)
    batches = [tr({"tokens": rng.integers(0, V, (4, S)).astype(np.int32)})
               for _ in range(STEPS)]
    mesh = jax_mesh.create_mesh(devices=jax.devices()[:1])
    # the reference's fused="ln" runs a fused_ln clone, which its
    # mlm_forward must be built on
    jm = J.Bert(vocab_size=V + 1, **GEOM, attn_impl="vmem", fused_ln=True)
    opt = dict(weight_decay=0.01, fused=True)
    jtx = jax_make_optimizer(jax_run_schedule(LR, total_steps=STEPS,
                                              warmup_steps=1), **opt)
    jstate = jax_create_train_state(jm, 0, jnp.zeros((1, S), jnp.int32), jtx,
                                    mesh)
    init = interop.bert_params_from_flax(_np_tree(jstate.params))
    jstep = jax_make_train_step(jm, jtx, mesh, input_key="tokens",
                                label_key="targets", fused="all",
                                forward_loss=J.mlm_forward(jm, chunk=16))
    want_losses = []
    for b in batches:
        jstate, metrics = jstep(jstate, b)
        want_losses.append(float(metrics["loss"]))
    model = T.Bert(vocab_size=V + 1, **GEOM, attn_impl="vmem", device="cpu")
    model.load_state_dict(init)
    tx = make_optimizer(run_schedule(LR, total_steps=STEPS, warmup_steps=1),
                        **opt)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, input_key="tokens", label_key="targets",
                           fused="all",
                           forward_loss=T.mlm_forward(model, chunk=16))
    assert step.fused == {"ln", "optimizer"} and model.fused_ln
    losses = [float(step(state, {k: torch.from_numpy(v) for k, v in
                                 b.items()})[1]["loss"]) for b in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_params(state.params(), interop.bert_params_from_flax(
        _np_tree(jstate.params)), "fused all", init, STEPS, LR)


def test_cli_refusals(corpus, tmp_path):
    base = [*FLAGS, "--device", "cpu", "--tokens", str(corpus / "train.bin"),
            "--vocab_size", "256", "--log_dir", str(tmp_path)]
    # --tensor composes with --cp (tests/test_torch_tp_cp.py): the
    # combination meets the CP refusal of a non-CP attention, as alone
    with pytest.raises(SystemExit, match="--cp needs a sequence-parallel"):
        main([*base, "--tensor", "2", "--cp", "2"])
    for extra, msg in ((["--cp", "2"], "--cp needs a sequence-parallel"),
                       (["--mask_id", "256"], "outside"),
                       (["--remat_layers"], "requires --scan_layers"),
                       (["--scan_layers", "--init_hf", str(corpus / "hf"),
                         "--mask_id", "255"], "unrolled layout"),
                       (["--init_hf", str(corpus / "hf")], "needs --mask_id")):
        with pytest.raises(SystemExit, match=msg):
            main([*base, *extra])
