"""Training the pipelined GPT-2 (``PipelinedGPT2`` through
``tpudist_torch.train`` and ``train_gpt2 --pipe``) against the JAX
package's ``PipelinedGPT2`` step on the same mesh of 4 CPU devices, in one
gloo world of 4 ranks.

- The reference's ``_GPT2_CFG`` (vocab 64, S 16, width 32, depth 4, 4
  heads), the weights carried from the reference's
  ``PipelinedGPT2.init`` through ``pipelined_gpt2_params_from_flax``, a
  batch of 8 in 4 microbatches: on ``data 2 x pipe 2`` and ``pipe 2 x
  tensor 2``, under GPipe and 1F1B, the first loss and three Adam steps
  against the reference's GPipe step (its 1F1B does not run on this jax:
  ROADMAP Queue 3). Bars: 2e-5 relative on the losses (the reference's
  own, tests/test_pipeline.py), ``rtol 2e-4`` on the parameters with an
  absolute floor of that bar times the parameter scale (the composed
  tests' bar, tests/torch_composed.py).
- The port's 1F1B against its GPipe: the first loss bit-equal (the same
  forward), the rest within the bars.
- A binding clip (``clip_norm`` 0.05 over the fused AdamW) on ``pipe 2 x
  tensor 2`` against the reference's clipped step: the norm summed over
  both groups.
- ``--amp``'s guard with a NaN in one stage's gradients: every rank
  skips the step (the flag summed over the pipe group).
- ``train_gpt2 --pipe 2 --fused optimizer`` on ``data 2 x pipe 2``
  against the reference's AdamW step on the same windows (its schedule,
  decay, clip; tests/test_torch_gpt2_train.py's bars) with the TSV rows
  rank 0 writes; a resume under ``--pipe 2`` equal to the uninterrupted
  run bit for bit; ``--pipe 4`` on that checkpoint refused with the
  reference's hint; ``--init_hf`` under ``--pipe 2`` the same run as
  the one built on its weights; ``--pipe 2 --tensor 2 --amp`` trains,
  checkpoints and resumes.
- ``grad_accum=2`` within the bars of the one-pass step.
- The reference's refusals under ``--pipe`` in its words, and the
  compositions not ported yet naming "Queue 1 #7c (remainder)".
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta

from tpudist import mesh as jax_mesh
from tpudist.models.gpt2 import PipelinedGPT2 as JPipelined
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import lm_loss as jax_lm_loss
from tpudist.train import make_train_step as jax_make_train_step
from tpudist.train import state_shardings_of
from tpudist_torch.interop import pipelined_gpt2_params_from_flax

from torch_composed import lm_cli_reference, lm_geometry_flags
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
V, S, B, MICRO, STEPS = 64, 16, 8, 4, 3
GEOM = dict(max_seq_len=S, hidden_dim=32, depth=4, num_heads=4)
MESHES = {"data2-pipe2": dict(data=2, pipe=2),
          "pipe2-tensor2": dict(data=1, pipe=2, tensor=2)}
#: the reference's bar on the losses (tests/test_pipeline.py)
LOSS_RTOL = 2e-5
#: three Adam steps of lr 1e-3 (tests/torch_composed.py's bar)
PARAM_RTOL, LR = 2e-4, 1e-3
CLIP = 0.05
CLI_S, CLI_B, CLI_STEPS, CLI_LR = 32, 2, 3, 1e-3
CLI_GEOM = dict(max_seq_len=CLI_S, hidden_dim=32, depth=4, num_heads=4)

WORKER = r"""
import contextlib, io, os, sys
import torch
import torch.distributed as dist
import tpudist_torch.train_gpt2 as TG
from tpudist_torch.amp import skipped_steps
from tpudist_torch.distributed import init_from_env
from tpudist_torch.mesh import MeshConfig, create_layout
from tpudist_torch.models.gpt2 import PipelinedGPT2
from tpudist_torch.optim import make_optimizer
from tpudist_torch.parallel import pp, tp
from tpudist_torch.train import create_train_state, lm_loss, make_train_step

torch.set_num_threads(1)
src, out = sys.argv[1], sys.argv[2]
ctx = init_from_env("cpu")
data = torch.load(src)
res = {}
layouts = {name: create_layout(MeshConfig(**axes))
           for name, axes in data["meshes"].items()}


def load(model, init, layout):
    model.load_state_dict(tp.shard_state_dict(
        pp.stage_state_dict(init, model.depth, layout), layout,
        table=model.tensor_specs))
    return model


for name, case in data["cases"].items():
    lay = layouts[case["mesh"]]
    model = load(PipelinedGPT2(lay, num_micro=data["micro"], vocab_size=data["V"],
                               **data["geom"], schedule=case["schedule"],
                               device="cpu"), data["init"], lay)
    fused = case["opt"] == "fused"
    tx = make_optimizer(data["lr"], fused=fused, clip_norm=case.get("clip"),
                        skip_nonfinite_updates=case.get("amp", False))
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, loss_fn=lm_loss, input_key="tokens",
                           label_key="tokens",
                           fused="optimizer" if fused else None,
                           grad_accum=case.get("accum", 1))
    nan_at = case.get("nan_at")
    now = {"step": 0}
    if nan_at is not None and lay.pipe_idx == 1:
        # a NaN in one leaf of the last stage's gradients at one step
        leaf = dict(model.named_parameters())[case["nan_leaf"]]
        leaf.register_hook(lambda g: g * float("nan")
                           if now["step"] == nan_at else g)
    losses = []
    for i, b in enumerate(case["batches"]):
        now["step"] = i
        rows = b.chunk(lay.data_parallel_size)[lay.replica]
        state, m = step(state, {"tokens": rows})
        losses.append(float(m["loss"]))
    res[(name, ctx.rank)] = {
        "losses": losses, "params": state.params(),
        "module": type(state.module).__name__,
        "leaves": sorted(k for k, _ in model.named_parameters()),
        "skipped": skipped_steps(state.opt_state) if case.get("amp") else 0,
        "replicas_agree": pp.replicas_agree(dict(model.named_parameters()),
                                            lay),
        "stage": (lay.pipe_idx, lay.tensor_idx, lay.data_idx)}

for tag, argv in data["cli"]:
    build_model = TG.build_model

    def build_loaded(args, dtype, attn, device, layout, _b=build_model):
        return load(_b(args, dtype, attn, device, layout), data["cli_init"],
                    layout)

    TG.build_model = build_loaded
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            state, losses = TG.main(["--device", "cpu", *argv])
        got = {"losses": losses, "params": state.params(),
               "stdout": printed.getvalue(),
               "replicas_agree": pp.replicas_agree(
                   dict(state.model.named_parameters()), state.model.layout)}
    except (ValueError, SystemExit, NotImplementedError) as e:
        got = {"error": f"{type(e).__name__}: {e}"}
    finally:
        TG.build_model = build_model
    res[(tag, ctx.rank)] = got

gathered = [None] * dist.get_world_size()
dist.all_gather_object(gathered, res)
if ctx.rank == 0:
    merged = {}
    for r in gathered:
        merged.update(r)
    torch.save(merged, out)
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""


def _spawn(tmp, payload, world=4):
    from torch_ports import free_port

    torch.save(payload, tmp / "in.pt")
    port = free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR":
               "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(tmp / "in.pt"),
             str(tmp / "out.pt")], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out.decode()[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return torch.load(tmp / "out.pt", weights_only=False)


def _reference(axes, tx, batches):
    """The reference's ``PipelinedGPT2`` (GPipe) step on ``axes`` over 4
    CPU devices: ``(init, losses, final)``, the parameters as the port's
    whole state dicts."""
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(**axes),
                                devices=jax.devices()[:4])
    model = JPipelined(mesh, num_micro=MICRO, vocab_size=V, **GEOM)
    state = jax_create_train_state(model, 0, jnp.zeros((B, S), jnp.int32),
                                   tx, mesh)
    step = jax_make_train_step(model, tx, mesh, loss_fn=jax_lm_loss,
                               input_key="tokens", label_key="tokens",
                               state_sharding=state_shardings_of(state))

    def params(st):
        return pipelined_gpt2_params_from_flax(
            jax.tree_util.tree_map(np.asarray, meta.unbox(st.params)))

    init, losses = params(state), []
    for b in batches:
        state, m = step(state, {"tokens": b})
        losses.append(float(m["loss"]))
    return init, losses, params(state)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_train")
    rng = np.random.Generator(np.random.PCG64(23))
    batches = [rng.integers(0, V, (B, S)).astype(np.int32)
               for _ in range(STEPS)]
    refs, init = {}, None
    for name, axes in MESHES.items():
        init, losses, final = _reference(axes, optax.adam(LR), batches)
        refs[name] = (losses, final)
    # the clipped step (clip_by_global_norm in front of Adam)
    _, losses, final = _reference(
        MESHES["pipe2-tensor2"], jax_make_optimizer(LR, clip_norm=CLIP),
        batches)
    refs["clip"] = (losses, final)
    tb = [torch.from_numpy(b) for b in batches]
    cases = {f"{name}-{sched}": {"mesh": name, "schedule": sched,
                                 "opt": "adam", "batches": tb}
             for name in MESHES for sched in ("gpipe", "1f1b")}
    # two microbatches of the step's rows, their gradients averaged
    cases["accum"] = {"mesh": "pipe2-tensor2", "schedule": "gpipe",
                      "opt": "adam", "accum": 2, "batches": tb}
    cases["clip"] = {"mesh": "pipe2-tensor2", "schedule": "gpipe",
                     "opt": "fused", "clip": CLIP, "batches": tb}
    # the same batch each step: a skipped step leaves the next loss as it
    cases["amp"] = {"mesh": "data2-pipe2", "schedule": "1f1b", "opt": "adam",
                    "amp": True, "nan_at": 1, "nan_leaf": "h.3.mlp_fc.weight",
                    "batches": [tb[0]] * 3}
    # the CLI: 2 replicas of 2 windows a step, 3 steps an epoch
    stream = rng.integers(0, V, CLI_STEPS * CLI_B * 2 * CLI_S).astype(
        np.uint16)
    stream.tofile(tmp / "tokens.bin")
    cli_init, cli_losses, cli_final = lm_cli_reference(
        stream, mesh={"data": 2}, replicas=2, vocab=V, geom=CLI_GEOM,
        batch=CLI_B, seq=CLI_S, steps=CLI_STEPS, lr=CLI_LR)
    cli = [*lm_geometry_flags(V, CLI_GEOM), "--tokens", str(tmp / "tokens.bin"),
           "--lr", str(CLI_LR), "--warmup_steps", "0", "--no_profiler",
           "--batch_size", str(CLI_B), "--pipe", "2", "--num_micro", "2",
           "--fused", "optimizer"]
    six = ["--total_steps", str(2 * CLI_STEPS)]
    # the CLI's init as a local HF checkpoint (--init_hf loads it whole)
    from tpudist_torch.interop import save_hf_checkpoint

    save_hf_checkpoint(cli_init, tmp / "hf", arch="gpt2",
                       depth=CLI_GEOM["depth"])
    # one replica under --tensor 2 reads both replicas' windows: 6 steps
    twelve = ["--total_steps", str(4 * CLI_STEPS)]
    got = _spawn(tmp, {
        "V": V, "geom": GEOM, "micro": MICRO, "lr": LR, "meshes": MESHES,
        "init": init, "cases": cases, "cli_init": cli_init,
        "cli": [
            ("cli", [*cli, "--total_steps", str(CLI_STEPS), "--log_dir",
                     str(tmp / "log"), "--pipe_schedule", "1f1b"]),
            ("init_hf", [*cli, "--total_steps", str(CLI_STEPS), "--log_dir",
                         str(tmp / "log"), "--pipe_schedule", "1f1b",
                         "--init_hf", str(tmp / "hf")]),
            ("first", [*cli, *six, "--log_dir", str(tmp / "l1"),
                       "--checkpoint_dir", str(tmp / "ck")]),
            ("resume", [*cli, *six, "--log_dir", str(tmp / "l1"),
                        "--checkpoint_dir", str(tmp / "ck"), "--epochs",
                        "2"]),
            ("whole", [*cli, *six, "--log_dir", str(tmp / "l2"),
                       "--checkpoint_dir", str(tmp / "ck2"), "--epochs",
                       "2"]),
            ("resize", [*cli, *six, "--log_dir", str(tmp / "l1"),
                        "--checkpoint_dir", str(tmp / "ck"), "--epochs",
                        "3", "--pipe", "4", "--num_micro", "1"]),
            ("tp_amp", [*cli, *twelve, "--tensor", "2", "--amp", "--log_dir",
                        str(tmp / "l3"), "--checkpoint_dir",
                        str(tmp / "ck3")]),
            ("tp_resume", [*cli, *twelve, "--tensor", "2", "--amp",
                           "--log_dir", str(tmp / "l3"), "--checkpoint_dir",
                           str(tmp / "ck3"), "--epochs", "2"]),
        ]})
    return refs, (cli_losses, cli_final), got, tmp


def _close(got, want_losses, want):
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    assert got["params"].keys() == want.keys()
    for k, w in want.items():
        g, w = got["params"][k].numpy(), np.asarray(w)
        if k.endswith("qkv.bias"):
            # the key bias: a zero gradient in exact arithmetic, which
            # Adam turns into a step of either sign (the step bound)
            assert np.abs(g[1]).max() <= 1.5 * STEPS * LR, k
            g, w = g[[0, 2]], w[[0, 2]]
        np.testing.assert_allclose(g, w, rtol=PARAM_RTOL,
                                   atol=PARAM_RTOL * LR * STEPS, err_msg=k)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_matches_the_references_pipeline(world, mesh, schedule):
    refs, _, got, _ = world
    for rank in range(4):
        r = got[(f"{mesh}-{schedule}", rank)]
        # no DDP: the step averages over the batch group after the ring
        assert r["module"] == "PipelinedGPT2"
        _close(r, *refs[mesh])
        # every rank of a replica logs the replicated head's loss
        assert r["losses"] == got[(f"{mesh}-{schedule}", 0)]["losses"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_stages_hold_their_blocks_under_global_names(world, mesh):
    _, _, got, _ = world
    for rank in range(4):
        r = got[(f"{mesh}-gpipe", rank)]
        stage = r["stage"][0]
        blocks = {int(k.split(".")[1]) for k in r["leaves"]
                  if k.startswith("h.")}
        assert blocks == {2 * stage, 2 * stage + 1}
        assert {"wte", "wpe", "ln_f.scale", "ln_f.bias"} <= set(r["leaves"])


@pytest.mark.parametrize("case", [
    *(f"{m}-{s}" for m in MESHES for s in ("gpipe", "1f1b")), "accum",
    "clip", "amp", "cli", "tp_amp", "tp_resume"])
def test_stages_keep_their_replicated_leaves_bit_equal(world, case):
    """Each stage holds its own copy of ``wte``, ``wpe`` and ``ln_f``, and
    only equal bits on every stage keep the copies equal (the reference
    holds one, psum'd): after the last step every rank's copies equal
    those of its pipe group's other ranks."""
    _, _, got, _ = world
    assert all(got[(case, rank)]["replicas_agree"] for rank in range(4))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_1f1b_against_gpipe(world, mesh):
    """The same forward (first loss bit-equal); the microbatches' gradient
    sums in the other order (the rest within the bars)."""
    _, _, got, _ = world
    a, b = got[(f"{mesh}-1f1b", 0)], got[(f"{mesh}-gpipe", 0)]
    assert a["losses"][0] == b["losses"][0]
    _close(a, b["losses"], b["params"])


def test_grad_accum_is_the_whole_batch_step(world):
    """``grad_accum=2`` on ``pipe 2 x tensor 2``: each step's rows as two
    microbatches, their gradients averaged over the batch group once,
    within the bars of the one-pass step (the reference's microbatch
    mean)."""
    _, _, got, _ = world
    whole = got[("pipe2-tensor2-gpipe", 0)]
    for rank in range(4):
        r = got[("accum", rank)]
        assert r["losses"] == got[("accum", 0)]["losses"]
        _close(r, whole["losses"], whole["params"])


def test_binding_clip_matches_the_reference(world):
    refs, _, got, _ = world
    for rank in range(4):
        _close(got[("clip", rank)], *refs["clip"])
    # the clip binds: the clipped run moved less than the unclipped one
    moved = lambda r: float((r["params"]["h.0.mlp_fc.weight"]
                             - got[("pipe2-tensor2-gpipe", 0)]["params"][
                                 "h.0.mlp_fc.weight"]).abs().max())
    assert moved(got[("clip", 0)]) > 0


def test_amp_skips_a_nan_in_one_stage_on_every_rank(world):
    _, _, got, _ = world
    runs = [got[("amp", rank)] for rank in range(4)]
    assert [r["skipped"] for r in runs] == [1, 1, 1, 1]
    losses = runs[0]["losses"]
    # step 1 skipped: step 2 sees step 1's parameters, on the same batch
    assert losses[2] == losses[1] and losses[1] != losses[0]
    assert all(r["losses"] == losses for r in runs)
    assert all(np.isfinite(r["params"]["h.3.mlp_fc.weight"].numpy()).all()
               for r in runs)


def test_cli_matches_the_reference_and_logs_rows(world):
    _, (want_losses, want), got, tmp = world
    for rank in range(4):
        r = got[("cli", rank)]
        assert "error" not in r, r.get("error")
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-5)
        for k, w in want.items():
            g, w = r["params"][k].numpy(), np.asarray(w)
            if k.endswith("qkv.bias"):
                assert np.abs(g[1]).max() <= 1.5 * CLI_STEPS * CLI_LR, k
                g, w = g[[0, 2]], w[[0, 2]]
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    # rank 0 (stage 0) writes the reference's TSV: g_step counts replicas
    tsv = (tmp / "log" / "GPT2_2_0.log").read_text().splitlines()
    assert tsv[0].split("\t") == ["datetime", "g_step", "g_img",
                                  "loss_value", "examples_per_sec"]
    assert tsv[-1].startswith("TrainTime")
    # the uninterrupted 6-step run: a row at step 5, g_step 5 x 2 replicas
    rows = [r.split("\t") for r in (tmp / "l2" / "GPT2_2_0.log")
            .read_text().splitlines() if r[:1].isdigit()]
    assert [r[1] for r in rows] == ["10"]
    assert float(rows[0][3]) == got[("whole", 0)]["losses"][4]
    # the other ranks write no rows
    other = (tmp / "l2" / "GPT2_2_1.log").read_text().splitlines()
    assert not [r for r in other if r[:1].isdigit()]
    assert "tokens/sec:" in got[("cli", 0)]["stdout"]
    # --init_hf --pipe 2: the whole HF tree loaded, each stage keeping its
    # blocks: the same run as the one built on those weights
    for rank in range(4):
        hf, cli = got[("init_hf", rank)], got[("cli", rank)]
        assert "error" not in hf, hf.get("error")
        assert hf["losses"] == cli["losses"]


def test_cli_resumes_bit_for_bit_and_refuses_a_pipe_resize(world):
    from tpudist_torch.checkpoint import META_FILE

    _, _, got, tmp = world
    saved = json.loads((tmp / "ck" / META_FILE).read_text())
    assert saved["pipe_world"] == 2 and saved["world_size"] == 2
    for rank in range(4):
        first, resume, whole = (got[(t, rank)] for t in ("first", "resume",
                                                          "whole"))
        assert "error" not in resume, resume.get("error")
        assert len(first["losses"]) == CLI_STEPS
        assert resume["losses"] == whole["losses"][CLI_STEPS:]
        assert resume["params"].keys() == whole["params"].keys()
        assert all(torch.equal(resume["params"][k], whole["params"][k])
                   for k in whole["params"])
        err = got[("resize", rank)].get("error", "")
        assert "only the data axis is elastic" in err, err
        assert "pipe_world 2 -> 4" in err, err


def test_cli_pipe_tensor_amp_trains_and_resumes(world):
    """``--pipe 2 --tensor 2 --amp``: every rank the same finite losses,
    nothing skipped; its checkpoint (the guard wraps the state: ``opt.inner``)
    holds each stage's tensor shards at
    their whole shapes under their global names, and a resume continues
    from it."""
    from tpudist_torch.checkpoint import Checkpointer

    _, _, got, tmp = world
    for tag in ("tp_amp", "tp_resume"):
        runs = [got[(tag, rank)] for rank in range(4)]
        for r in runs:
            assert "error" not in r, r.get("error")
            assert len(r["losses"]) == 2 * CLI_STEPS
            assert np.isfinite(r["losses"]).all()
            assert r["losses"] == runs[0]["losses"]
        assert "amp: skipped" not in runs[0]["stdout"]
    shapes = {k: tuple(v[0]) for k, v in Checkpointer(tmp / "ck3")
              .saved_metadata(2 * CLI_STEPS).items()}
    d = CLI_GEOM["hidden_dim"]
    for i in range(CLI_GEOM["depth"]):
        assert shapes[f"opt.inner.master.h.{i}.qkv.weight"] == (3 * d, d)
        assert shapes[f"opt.inner.mu.h.{i}.mlp_proj.weight"] == (d, 4 * d)
    assert shapes["opt.inner.master.wte"] == (V, d)


_BASE = ["--device", "cpu", "--pipe", "2"]


@pytest.mark.parametrize("flags,raises", [
    (["--attn", "vmem"], (SystemExit, "runs XLA attention")),
    (["--dropout", "0.1"], (SystemExit,
                            "--dropout is not supported with --pipe")),
    (["--arch", "llama"], (SystemExit, "--pipe supports the gpt2 arch only")),
    (["--scan_layers"], (SystemExit, "--scan_layers/--remat_layers are not "
                         "supported with --pipe")),
    (["--remat_policy", "full"], (SystemExit, "--remat_policy is not "
                                  "supported with --pipe")),
    (["--chunked_ce", "8"], (SystemExit,
                             "--chunked_ce does not compose with --pipe")),
    (["--eval"], (SystemExit, "support the non-cp, non-pipe paths")),
    (["--generate", "4"], (SystemExit, "support the non-cp, non-pipe")),
    (["--fused", "all"], (ValueError, "PipelinedGPT2 has no fused_ln knob")),
    (["--fused", "ln"], (ValueError, "PipelinedGPT2 has no fused_ln knob")),
    (["--fsdp", "2"], (NotImplementedError, r"#7c \(remainder\)")),
    (["--shard_opt_state"], (NotImplementedError, r"#7c \(remainder\)")),
    (["--cp", "2"], (NotImplementedError, r"#7c \(remainder\)")),
    (["--remat", "full"], (NotImplementedError, r"#7c \(remainder\)")),
    (["--elastic"], (NotImplementedError, r"#7c \(remainder\)")),
], ids=lambda f: " ".join(f) if isinstance(f, list) else "")
def test_pipe_refusals(flags, raises, monkeypatch):
    """The reference's refusals under ``--pipe`` (examples/train_gpt2.py),
    in its words, before any work; the fused LN refused by the model (one
    pipe rank here: the model is built on a layout of pipe 1 on a world
    of one, as the check needs no world)."""
    from tpudist_torch import train_gpt2
    from tpudist_torch.models import gpt2 as G

    if flags[0] == "--fused":
        from tpudist_torch.optim import make_optimizer
        from tpudist_torch.train import make_train_step

        model = G.PipelinedGPT2(None, num_micro=2, vocab_size=V, **GEOM,
                                device="cpu")
        with pytest.raises(raises[0], match=raises[1]):
            make_train_step(model, make_optimizer(1e-3, fused=True),
                            fused=flags[1])
        return
    with pytest.raises(raises[0], match=raises[1]):
        train_gpt2.main([*_BASE, *flags])


def test_pipelined_model_refuses_what_the_reference_refuses():
    from tpudist_torch.mesh import RankLayout
    from tpudist_torch.models.gpt2 import GPT2, PipelinedGPT2

    with pytest.raises(ValueError, match="depth 4 not divisible by pipe=3"):
        PipelinedGPT2(RankLayout(0, 1, 1, pipe=3), num_micro=2, vocab_size=V,
                      **GEOM, device="cpu")
    with pytest.raises(ValueError, match="runs XLA attention"):
        PipelinedGPT2(None, num_micro=2, attn_impl="vmem", vocab_size=V,
                      **GEOM, device="cpu")
    with pytest.raises(ValueError, match="schedule must be one of"):
        PipelinedGPT2(None, num_micro=2, schedule="2f2b", vocab_size=V,
                      **GEOM, device="cpu")
    # one stage: the plain model's function from the same seed
    piped = PipelinedGPT2(None, num_micro=2, vocab_size=V, **GEOM,
                          device="cpu")
    plain = GPT2(vocab_size=V, **GEOM, device="cpu")
    tokens = torch.randint(0, V, (4, S))
    assert torch.equal(piped(tokens), plain(tokens))
    with pytest.raises(ValueError, match="no decode path"):
        piped.init_cache(1)
