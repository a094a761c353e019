"""The port's expert axis (``tpudist_torch.parallel.ep`` over a layout's
expert group, through ``tpudist_torch.train`` and ``train_gpt2
--experts``) against the JAX package's single-device einsum model, in one
gloo world of 4 ranks; the MoE serving paths against the reference's.

- ``data 2 x expert 2`` and ``expert 2 x tensor 2`` (GPT-2 with GELU
  experts, both dispatches; Llama with SwiGLU experts), the weights from
  the reference's init (vocab 64, S 16, width 32, depth 2, 4 experts
  every block, capacity 1.25): the whole gradients at init against
  ``jax.grad`` of the reference's loss (CE plus the aux losses) on the
  whole batch (``GRAD_REL`` of each leaf's largest), then three Adam
  steps against the reference's step (tests/test_torch_ep.py's bars). A
  gradient counted ``expert`` times (the all_gather's transpose taken as
  a reduce-scatter of identical cotangents) or a token gradient missing
  the other ranks' experts fails the first check.
- ZeRO-1 under expert (the expert leaves' state kept whole, as the
  reference exempts them) and a binding clip over the fused AdamW (an
  expert leaf's squares summed over the expert group) against the
  reference's steps.
- ``train_gpt2 --experts 4`` on the world: ``--expert_axis 2`` against
  the reference's AdamW step on the same windows (tests/torch_composed.py's
  CLI bars) with the TSV rows rank 0 writes; ``--tensor 2`` with
  ``--generate`` (the same tokens on every rank); ``--amp --grad_accum 2
  --chunked_ce 8 --shard_opt_state`` checkpointed and resumed equal to
  the uninterrupted run bit for bit; a resume at another expert axis
  refused with the reference's hint.
- One rank: ``ServeEngine`` greedy streams on an MoE GPT-2 (paged,
  both dispatches) equal to the reference engine's; ``main --serve
  --serve_experts 4`` prints the same under both dispatches;
  ``train_gpt2 --experts 4 --device cpu`` writes its TSV rows; the
  reference's refusals with ``--experts`` in its words, and the
  compositions not ported yet naming "Queue 1 #7d (remainder)".
"""

import contextlib
import io
import os
import re
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
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.models.llama import Llama as JLlama
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import lm_loss as jax_lm_loss
from tpudist.train import make_train_step as jax_make_train_step
from tpudist.train import state_shardings_of
from tpudist_torch.interop import gpt2_params_from_flax, llama_params_from_flax

from torch_composed import (
    assert_cli_close, lm_cli_reference, lm_geometry_flags)
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
V, S, B, STEPS, LR = 64, 16, 8, 3, 1e-3
MOE = dict(num_experts=4, capacity_factor=1.25, moe_every=1)
GEOM = {"gpt2": dict(max_seq_len=S, hidden_dim=32, depth=2, num_heads=4,
                     **MOE),
        "llama": dict(max_seq_len=S, hidden_dim=32, depth=2, num_heads=4,
                      num_kv_heads=2, ffn_dim=48, **MOE)}
MESHES = {"d2e2": dict(data=2, expert=2),
          "e2t2": dict(data=1, expert=2, tensor=2)}
#: the whole gradients at init against the reference's, relative to each
#: leaf's largest element (float32 sums in other orders)
GRAD_REL = 2e-5
CLIP = 0.05
NOISE_SHARE, CLI_S, CLI_B, CLI_STEPS, CLI_LR = 1e-5, 16, 2, 3, 1e-3
CLI_GEOM = dict(max_seq_len=CLI_S, hidden_dim=32, depth=2, num_heads=4,
                **MOE)

WORKER = r"""
import contextlib, io, os, sys
import torch
import torch.distributed as dist
import tpudist_torch.train_gpt2 as TG
from tpudist_torch.distributed import init_from_env
from tpudist_torch.mesh import MeshConfig, create_layout
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.llama import Llama
from tpudist_torch.optim import make_optimizer, shard_state
from tpudist_torch.parallel import ep, tp
from tpudist_torch.train import (
    create_train_state, lm_loss, make_train_step, tp_lm_loss)

torch.set_num_threads(1)
src, out = sys.argv[1], sys.argv[2]
ctx = init_from_env("cpu")
data = torch.load(src)
res = {}
layouts = {name: create_layout(MeshConfig(**axes))
           for name, axes in data["meshes"].items()}


def build(case, lay):
    cls = GPT2 if case["arch"] == "gpt2" else Llama
    model = cls(vocab_size=data["V"], **case["geom"], device="cpu",
                layout=lay)
    model.load_state_dict(tp.shard_state_dict(
        data["init"][case["arch"]], lay, table=model.tensor_specs))
    return model


def rows(b, lay):
    return b.chunk(lay.data_parallel_size)[lay.replica]


for name, case in data["cases"].items():
    lay = layouts[case["mesh"]]
    model = build(case, lay)
    state = create_train_state(model, make_optimizer(data["lr"]))
    model.train()
    tokens = rows(case["batches"][0], lay).long()
    if lay.tensor > 1:
        loss = tp_lm_loss(state.module(tokens, vocab_local=True), tokens,
                          lay, data["V"])
    else:
        loss = lm_loss(state.module(tokens), tokens)
    (loss + ep.moe_losses(model)).backward()
    grads = tp.gather_state_dict(
        {k: p.grad for k, p in model.named_parameters()}, lay, data["V"],
        table=model.tensor_specs)
    model = build(case, lay)
    fused = case.get("fused", False)
    tx = make_optimizer(data["lr"], fused=fused, clip_norm=case.get("clip"))
    if case.get("zero1"):
        tx = shard_state(tx, lay)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, loss_fn=lm_loss, input_key="tokens",
                           label_key="tokens",
                           fused="optimizer" if fused else None)
    losses = []
    for b in case["batches"]:
        state, m = step(state, {"tokens": rows(b, lay)})
        losses.append(float(m["loss"]))
    got = {"losses": losses, "params": state.params(), "grads": grads,
           "module": type(state.module).__name__,
           "w1": tuple(model.h[0].moe.w1.shape) if case["arch"] == "gpt2"
           else None}
    if case.get("zero1"):
        got["modes"] = {k: v[0] for k, v in state.opt_state.modes.items()}
    res[(name, ctx.rank)] = got

for tag, argv in data["cli"]:
    build_model = TG.build_model

    def build_loaded(args, dtype, attn, device, layout, _b=build_model):
        model = _b(args, dtype, attn, device, layout)
        model.load_state_dict(tp.shard_state_dict(
            data["cli_init"], layout, table=model.tensor_specs))
        return model

    TG.build_model = build_loaded
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            state, losses = TG.main(["--device", "cpu", *argv])
        got = {"losses": losses, "params": state.params(),
               "stdout": printed.getvalue()}
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
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out.decode()[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return torch.load(tmp / "out.pt", weights_only=False)


def _reference(arch, batches, tx):
    """The reference's single-device einsum model: ``(init, grads at init
    on the first batch, losses, final)`` as the port's state dicts."""
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(data=1),
                                devices=jax.devices()[:1])
    cls, convert = ((JGPT2, gpt2_params_from_flax) if arch == "gpt2" else
                    (JLlama, llama_params_from_flax))
    model = cls(vocab_size=V, **GEOM[arch], moe_dispatch="einsum")
    state = jax_create_train_state(model, 0, jnp.zeros((B, S), jnp.int32),
                                   tx, mesh)
    step = jax_make_train_step(model, tx, mesh, loss_fn=jax_lm_loss,
                               input_key="tokens", label_key="tokens",
                               state_sharding=state_shardings_of(state))
    params = meta.unbox(state.params)

    def loss(p, tokens):
        logits, upd = model.apply({"params": p}, tokens, train=True,
                                  mutable=["losses"])
        return jax_lm_loss(logits, tokens) + sum(
            jax.tree_util.tree_leaves(upd["losses"]), 0.0)

    as_np = lambda t: convert(jax.tree_util.tree_map(np.asarray, t))  # noqa
    grads = as_np(jax.grad(loss)(params, jnp.asarray(batches[0])))
    init, losses = as_np(params), []
    for b in batches:
        state, m = step(state, {"tokens": b})
        losses.append(float(m["loss"]))
    return init, grads, losses, as_np(meta.unbox(state.params))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_train")
    rng = np.random.Generator(np.random.PCG64(31))
    batches = [rng.integers(0, V, (B, S)).astype(np.int32)
               for _ in range(STEPS)]
    refs, inits = {}, {}
    for arch in ("gpt2", "llama"):
        init, grads, losses, final = _reference(arch, batches,
                                                optax.adam(LR))
        inits[arch] = init
        refs[arch] = (grads, losses, final)
    *_, clip_losses, clip_final = _reference(
        "gpt2", batches, jax_make_optimizer(LR, clip_norm=CLIP))
    refs["clip"] = (refs["gpt2"][0], clip_losses, clip_final)
    tb = [torch.from_numpy(b) for b in batches]
    cases = {}
    for mesh in MESHES:
        for impl in ("einsum", "index"):
            cases[f"{mesh}-{impl}"] = {
                "mesh": mesh, "arch": "gpt2", "batches": tb,
                "geom": dict(GEOM["gpt2"], moe_dispatch=impl)}
    cases["e2t2-llama"] = {"mesh": "e2t2", "arch": "llama", "batches": tb,
                           "geom": dict(GEOM["llama"], moe_dispatch="index")}
    cases["zero1"] = dict(cases["d2e2-index"], zero1=True)
    cases["clip"] = dict(cases["e2t2-index"], fused=True, clip=CLIP)
    # the CLI: 2 replicas of 2 windows a step, 3 steps an epoch
    stream = rng.integers(0, V, CLI_STEPS * CLI_B * 2 * CLI_S).astype(
        np.uint16)
    stream.tofile(tmp / "tokens.bin")
    cli_init, cli_losses, cli_final = lm_cli_reference(
        stream, mesh={"data": 1}, replicas=2, vocab=V, geom=CLI_GEOM,
        batch=CLI_B, seq=CLI_S, steps=CLI_STEPS, lr=CLI_LR)
    tp_ref = lm_cli_reference(
        stream, mesh={"data": 1}, replicas=1, vocab=V, geom=CLI_GEOM,
        batch=CLI_B, seq=CLI_S, steps=2 * CLI_STEPS, lr=CLI_LR)
    cli = [*lm_geometry_flags(V, CLI_GEOM), "--tokens", str(tmp / "tokens.bin"),
           "--lr", str(CLI_LR), "--warmup_steps", "0", "--no_profiler",
           "--batch_size", str(CLI_B), "--experts", "4", "--moe_every", "1",
           "--fused", "optimizer"]
    # one step an epoch: 2 replicas x 2 microbatches x 2 windows
    six = ["--total_steps", str(2 * CLI_STEPS), "--amp", "--grad_accum", "2",
           "--chunked_ce", "8", "--shard_opt_state", "--expert_axis", "2",
           "--moe_dispatch", "index"]
    got = _spawn(tmp, {
        "V": V, "lr": LR, "meshes": MESHES, "init": inits, "cases": cases,
        "cli_init": cli_init,
        "cli": [
            ("cli", [*cli, "--total_steps", str(CLI_STEPS), "--expert_axis",
                     "2", "--log_dir", str(tmp / "log")]),
            ("tp_cli", [*cli, "--total_steps", str(2 * CLI_STEPS),
                        "--expert_axis", "2", "--tensor", "2",
                        "--moe_dispatch", "index", "--generate", "4",
                        "--log_dir", str(tmp / "l0")]),
            ("first", [*cli, *six, "--log_dir", str(tmp / "l1"),
                       "--checkpoint_dir", str(tmp / "ck"), "--epochs",
                       "2"]),
            ("resume", [*cli, *six, "--log_dir", str(tmp / "l1"),
                        "--checkpoint_dir", str(tmp / "ck"), "--epochs",
                        "4"]),
            ("whole", [*cli, *six, "--log_dir", str(tmp / "l2"),
                       "--checkpoint_dir", str(tmp / "ck2"), "--epochs",
                       "4"]),
            ("resize", [*cli, *six[:-4], "--expert_axis", "1", "--elastic",
                        "--log_dir", str(tmp / "l1"), "--checkpoint_dir",
                        str(tmp / "ck"), "--epochs", "6"]),
        ]})
    return refs, (cli_losses, cli_final), tp_ref, got, tmp


def _grads_close(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=k)


def _steps_close(r, want_losses, want, grads):
    from torch_composed import assert_close

    bound = 1.5 * STEPS * LR
    params = dict(r["params"])
    for k, g in grads.items():
        g = np.asarray(g)
        mask = np.abs(g) <= NOISE_SHARE * np.abs(g).max()
        if k.endswith("qkv.bias") or not mask.any():
            continue
        p, w = params[k].numpy(), np.asarray(want[k])
        assert np.abs(p - w)[mask].max() <= bound, k
        params[k] = torch.from_numpy(np.where(mask, w, p))
    assert_close({"losses": r["losses"], "params": params}, want_losses,
                 want, sgd=False, steps=STEPS, lr=LR)


CASES = [f"{m}-{i}" for m in MESHES for i in ("einsum", "index")] + [
    "e2t2-llama"]


@pytest.mark.parametrize("case", CASES)
def test_gradients_and_steps_match_the_single_device_reference(world, case):
    refs, _, _, got, _ = world
    grads, losses, final = refs["llama" if "llama" in case else "gpt2"]
    for rank in range(4):
        r = got[(case, rank)]
        _grads_close(r["grads"], grads)
        _steps_close(r, losses, final, grads)
        assert r["losses"] == got[(case, 0)]["losses"]


def test_ranks_hold_their_experts_and_ddp_spans_the_replicas(world):
    _, _, _, got, _ = world
    # data 2 x expert 2: DDP over the ranks with this expert index
    assert {got[("d2e2-index", r)]["module"] for r in range(4)} == {
        "DistributedDataParallel"}
    # expert 2 x tensor 2: one replica, no DDP; 2 of 4 experts, half the
    # ffn width
    assert got[("e2t2-index", 0)]["module"] == "GPT2"
    assert got[("d2e2-index", 0)]["w1"] == (2, 32, 128)
    assert got[("e2t2-index", 0)]["w1"] == (2, 32, 64)


def test_zero1_under_expert_keeps_the_expert_state_whole(world):
    refs, _, _, got, _ = world
    grads, losses, final = refs["gpt2"]
    for rank in range(4):
        r = got[("zero1", rank)]
        _steps_close(r, losses, final, grads)
        experts = {k: m for k, m in r["modes"].items() if ".moe.w" in k}
        assert experts and set(experts.values()) == {"replicate"}
        assert "shard" in set(r["modes"].values()) | {"pad"}


def test_binding_clip_sums_over_the_expert_group(world):
    refs, _, _, got, _ = world
    grads, losses, final = refs["clip"]
    for rank in range(4):
        _steps_close(got[("clip", rank)], losses, final, grads)


def test_cli_matches_the_reference_and_logs_rows(world):
    _, (want_losses, want), _, got, tmp = world
    for rank in range(4):
        r = got[("cli", rank)]
        assert "error" not in r, r
        assert_cli_close(r, want_losses, want, steps=CLI_STEPS, lr=CLI_LR)
    # rank 0 writes the reference's TSV: g_step counts replicas
    tsv = (tmp / "log" / "GPT2_2_0.log").read_text().splitlines()
    assert tsv[0].split("\t") == ["datetime", "g_step", "g_img",
                                  "loss_value", "examples_per_sec"]
    assert tsv[-1].startswith("TrainTime")
    # the other ranks write no rows
    for other in (tmp / "log").glob("GPT2_2_[123].log"):
        assert not [r for r in other.read_text().splitlines()
                    if r[:1].isdigit()]


def test_cli_expert_x_tensor_generates_on_every_rank(world):
    _, _, (_, want_losses, want), got, tmp = world
    runs = [got[("tp_cli", rank)] for rank in range(4)]
    assert all("error" not in r for r in runs), runs[0]
    assert_cli_close(runs[0], want_losses, want, steps=2 * CLI_STEPS,
                     lr=CLI_LR)
    printed = re.findall(r"generated tokens: (\[.*\])", runs[0]["stdout"])
    assert len(printed) == 1 and len(eval(printed[0])) == 4
    # 6 steps of one replica: a row at step 5
    rows = [r.split("\t") for r in (tmp / "l0" / "GPT2_2_0.log")
            .read_text().splitlines() if r[:1].isdigit()]
    assert [r[1] for r in rows] == ["5"]
    assert float(rows[0][3]) == runs[0]["losses"][4]


def test_resume_under_expert_is_the_uninterrupted_run(world):
    _, _, _, got, _ = world
    for rank in range(4):
        first, resume = got[("first", rank)], got[("resume", rank)]
        whole = got[("whole", rank)]
        assert "error" not in whole, whole
        assert first["losses"] + resume["losses"] == whole["losses"]
        for k, w in whole["params"].items():
            assert torch.equal(resume["params"][k], w), k


def test_expert_resize_is_refused(world):
    _, _, _, got, _ = world
    err = got[("resize", 0)]["error"]
    assert "expert_world 2 -> 1" in err and "only the data axis" in err, err


# ---------------------------------------------------------------------------
# one rank: serving, the CLI's rows and refusals


def _serve_models(impl):
    from tpudist_torch.models.gpt2 import GPT2

    geom = dict(vocab_size=V, max_seq_len=64, hidden_dim=32, depth=2,
                num_heads=4, num_experts=4, moe_dispatch=impl)
    jm = JGPT2(**geom, attn_impl="fused")
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(jm.init(
        jax.random.key(2), np.zeros((1, 8), np.int32), train=False)[
        "params"]))
    pm = GPT2(**geom, attn_impl="fused", device="cpu")
    pm.load_state_dict(gpt2_params_from_flax(params))
    return jm, params, pm


@pytest.mark.parametrize("impl", ["einsum", "index"])
def test_moe_engine_greedy_streams_match_the_reference_engine(impl):
    """The paged engine on an MoE GPT-2 (every other block 4 experts):
    prefill routes the padded bucket as the reference pads it, decode one
    token a group; the greedy streams equal the reference engine's."""
    from tpudist.serve import ServeEngine as JServeEngine
    from tpudist_torch.serve import ServeEngine

    jm, params, pm = _serve_models(impl)
    rng = np.random.Generator(np.random.PCG64(6))
    prompts = [rng.integers(0, V, (n,)).astype(np.int32) for n in (5, 9, 12)]
    jeng = JServeEngine(jm, jax.tree_util.tree_map(jnp.asarray, params),
                        max_slots=3, seed=0, paged=True, block_size=8,
                        watermark_blocks=2)
    jr = [jeng.submit(p, 8) for p in prompts]
    jout = jeng.run()
    peng = ServeEngine(pm, max_slots=3, seed=0, paged=True, block_size=8,
                       watermark_blocks=2)
    pr = [peng.submit(p, 8) for p in prompts]
    pout = peng.run()
    for a, b in zip(jr, pr):
        assert pout[b] == jout[a]


def test_main_serve_experts_is_the_same_under_both_dispatches(tmp_path):
    from tpudist_torch.main import main

    outs = []
    for impl in ("einsum", "index"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--device", "cpu", "--serve", "--serve_experts", "4",
                  "--serve_moe_dispatch", impl, "--serve_requests", "3",
                  "--log_dir", str(tmp_path / impl)])
        outs.append(re.findall(r"request \d+: \d+ tokens \(done\)",
                               buf.getvalue()))
    assert len(outs[0]) == 3 and outs[0] == outs[1]


def test_cli_experts_writes_its_rows(tmp_path):
    from tpudist_torch.train_gpt2 import main

    state, losses = main([
        "--device", "cpu", "--vocab_size", "64", "--seq_len", "16",
        "--hidden_dim", "32", "--depth", "2", "--num_heads", "4",
        "--batch_size", "2", "--synthetic_tokens", "1024", "--experts", "4",
        "--moe_top_k", "1", "--router_z_loss", "0.01", "--no_profiler",
        "--log_dir", str(tmp_path), "--JobID", "E"])
    rows = [r.split("\t") for r in (tmp_path / "E_2_0.log").read_text()
            .splitlines() if r[:1].isdigit()]
    assert len(losses) == 1024 // (2 * 16) and rows
    assert np.isfinite(losses).all()
    # GPT-2's default cadence: block 1 of 2 is the MoE block
    assert [hasattr(b, "moe") for b in state.model.h] == [False, True]


REFUSALS = [
    (["--init_hf", "hf"], SystemExit, "--init_hf converts dense checkpoints"),
    (["--scan_layers"], SystemExit, "--scan_layers supports dense training "
     "only"),
    (["--arch", "llama", "--scan_layers"], SystemExit,
     "--scan_layers uses the stacked dense layout"),
    (["--pipe", "2"], SystemExit, "MoE/context-parallel/kernel attention "
     "are not pipelined"),
    (["--fsdp", "2"], NotImplementedError, r"Queue 1 #7d \(remainder\)"),
    (["--cp", "2", "--attn", "ring"], NotImplementedError,
     r"Queue 1 #7d \(remainder\)"),
    (["--chunked_ce", "8", "--router_jitter", "0.1"], ValueError,
     "does not support router_jitter"),
]


@pytest.mark.parametrize("flags,exc,words", REFUSALS)
def test_cli_refusals_with_experts(flags, exc, words, tmp_path):
    from tpudist_torch.train_gpt2 import main

    with pytest.raises(exc, match=words):
        main(["--device", "cpu", "--vocab_size", "64", "--seq_len", "16",
              "--hidden_dim", "32", "--depth", "2", "--num_heads", "4",
              "--batch_size", "2", "--synthetic_tokens", "1024",
              "--experts", "4", "--no_profiler", "--log_dir",
              str(tmp_path), *flags])


def test_mesh_refuses_expert_beside_fsdp_seq_and_pipe():
    from tpudist_torch.mesh import MeshConfig

    for axes in (dict(fsdp=2), dict(seq=2), dict(pipe=2)):
        with pytest.raises(NotImplementedError,
                           match=r"Queue 1 #7d \(remainder\)"):
            MeshConfig(data=1, expert=2, **axes).axis_sizes(4)
