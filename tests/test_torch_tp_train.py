"""Training over ``data x tensor`` (``tpudist_torch.train`` with a model
on a tensor layout, ``train_gpt2 --tensor``) against the JAX package's
step on a ``MeshConfig(data=2, tensor=2)`` mesh of 4 CPU devices.

- GPT-2 and GQA Llama (V 64: the reference's ``NamedSharding`` refuses a
  vocabulary the tensor axis does not divide; the uneven split is held
  to the unsharded port in test_torch_tp.py), in gloo worlds of 4 ranks
  (``data 2 x tensor 2``) and 2 ranks (``tensor 2``): the loss
  and the parameters after one SGD step within the reference's own bar
  (``atol=rtol=1e-5``, tests/test_tensor_parallel.py) and after 3 Adam
  steps within ``rtol 2e-4`` (tests/test_parallel_plan.py), with an
  absolute floor of that bar times the parameter scale for elements Adam
  moves from zero.
- ``train_gpt2 --tensor 2 --fused all --chunked_ce 5 --attn vmem`` on the
  4-rank world against the reference's AdamW step with its schedule,
  decay and clipping (``test_torch_gpt2_train.py``'s bars); with ``--amp
  --generate --eval`` it trains, skips nothing and decodes.
- A DCP checkpoint under ``data 2 x tensor 2`` holds each sharded leaf at
  its whole shape and restores bit for bit; ``--tensor`` with ``--fsdp``
  / ``--cp`` / ``--shard_opt_state`` accepted (run in
  test_torch_tp_fsdp.py, test_torch_tp_cp.py, test_torch_tp_zero1.py)
  and ZeRO-1 under a tensor plan built; the refusals: the MoE flags with
  ``--tensor`` (``--pipe`` with it needs its ranks), the explicit reducer, a tensor resize on
  resume.
"""

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
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.models.llama import Llama as JLlama
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.optim import run_schedule as jax_run_schedule
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import lm_loss as jax_lm_loss
from tpudist.train import make_train_step as jax_make_train_step
from tpudist.train import state_shardings_of
from tpudist_torch.interop import gpt2_params_from_flax, llama_params_from_flax
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
V, S, B = 64, 16, 8
GEOM = {"gpt2": dict(max_seq_len=S, hidden_dim=32, depth=2, num_heads=4),
        "llama": dict(max_seq_len=S, hidden_dim=32, depth=2, num_heads=4,
                      num_kv_heads=2, ffn_dim=64)}
# the CLI's windows and schedule
CLI_B, CLI_STEPS, CLI_LR = 2, 3, 1e-3


def _mesh():
    return jax_mesh.create_mesh(jax_mesh.MeshConfig(data=2, tensor=2),
                                devices=jax.devices()[:4])


def _jax_model(arch):
    if arch == "gpt2":
        return JGPT2(vocab_size=V, **GEOM[arch], attn_impl="xla"), \
            gpt2_params_from_flax
    return JLlama(vocab_size=V, **GEOM[arch], attn_impl="xla"), \
        llama_params_from_flax


def _reference(arch, tx, batches, rows):
    """The reference's step on the data x tensor mesh: the initial
    parameters as the port's state dict, the losses, the final ones."""
    model, convert = _jax_model(arch)
    mesh = _mesh()
    state = jax_create_train_state(model, 0, jnp.zeros((rows, S), jnp.int32),
                                   tx, mesh)
    step = jax_make_train_step(model, tx, mesh, loss_fn=jax_lm_loss,
                               input_key="tokens", label_key="tokens",
                               state_sharding=state_shardings_of(state))

    def params(st):
        return convert(jax.tree_util.tree_map(np.asarray,
                                              meta.unbox(st.params)))

    init, losses = params(state), []
    for b in batches:
        state, m = step(state, {"tokens": b})
        losses.append(float(m["loss"]))
    return init, losses, params(state)


CASES = {("gpt2", "sgd"): 1, ("gpt2", "adam"): 3, ("llama", "adam"): 3}

WORKER = r"""
import os
import sys
import torch
import torch.distributed as dist
import tpudist_torch.train_gpt2 as TG
from tpudist_torch.checkpoint import Checkpointer
from tpudist_torch.distributed import init_from_env
from tpudist_torch.mesh import MeshConfig, create_layout
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.llama import Llama
from tpudist_torch.optim import SGD, make_optimizer
from tpudist_torch.parallel import tp
from tpudist_torch.train import create_train_state, lm_loss, make_train_step

torch.set_num_threads(1)
src, out = sys.argv[1], sys.argv[2]
ctx = init_from_env("cpu")
data = torch.load(src)
lay = create_layout(MeshConfig(data=-1, tensor=2))
res = {"worlds": (lay.data, lay.tensor)}


def build(arch):
    cls = GPT2 if arch == "gpt2" else Llama
    model = cls(vocab_size=data["V"], **data["geom"][arch], device="cpu",
                layout=lay)
    model.load_state_dict(tp.shard_state_dict(data["init"][arch], lay))
    return model


def tp_local(t):
    return t.to_local() if hasattr(t, "to_local") else t


for (arch, opt), batches in data["batches"].items():
    model = build(arch)
    tx = SGD(0.1, momentum=0.0) if opt == "sgd" else make_optimizer(1e-3)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, loss_fn=lm_loss, input_key="tokens",
                           label_key="tokens")
    losses = []
    for b in batches:
        state, m = step(state, {"tokens": b.chunk(lay.data)[lay.data_idx]})
        losses.append(float(m["loss"]))
    res[(arch, opt)] = {"losses": losses, "params": state.params(),
                        "ddp": type(state.module).__name__}
    if (arch, opt) == ("gpt2", "adam") and lay.data == 2:
        # a checkpoint of the sharded state, restored into a fresh one
        ck = Checkpointer(data["ckpt"])
        ck.save(state, wait=True)
        fresh = create_train_state(build(arch), make_optimizer(1e-3))
        ck.restore(fresh)
        a, b = state.state_dict(), fresh.state_dict()
        same = all(torch.equal(tp_local(a["opt"][g][k]),
                               tp_local(b["opt"][g][k]))
                   for g in ("mu", "nu") for k in a["opt"][g])
        same &= all(torch.equal(p, q) for p, q in zip(
            state.model.parameters(), fresh.model.parameters()))
        res["restored"] = same and fresh.step == state.step
        res["saved_shapes"] = {k: tuple(v[0]) for k, v in
                               ck.saved_metadata(state.step).items()}
        ck.close()

if lay.data == 2:
    build_model = TG.build_model

    def build_loaded(args, dtype, attn, device, layout):
        model = build_model(args, dtype, attn, device, layout)
        model.load_state_dict(tp.shard_state_dict(data["init"]["gpt2"],
                                                  layout))
        return model

    TG.build_model = build_loaded
    destroy, dist.destroy_process_group = (dist.destroy_process_group,
                                           lambda: None)
    state, losses = TG.main(["--device", "cpu", *data["cli"]])
    res["cli"] = {"losses": losses, "params": state.params()}
    import contextlib, io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state, losses = TG.main(["--device", "cpu", *data["cli"], "--amp",
                                 "--generate", "4", "--eval", "--log_dir",
                                 data["ckpt"] + "_amp"])
    res["amp"] = {"losses": losses, "out": buf.getvalue()}
    dist.destroy_process_group = destroy


if ctx.rank == 0:
    torch.save(res, out)
# every rank here past the last collective: leave without the interpreter's
# teardown of the gloo threads (an abort there under a loaded host would
# fail a world whose results are written)
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""


def _spawn(tmp, world, payload):
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


def _cli_reference(stream):
    """The reference's AdamW step (schedule, decay 0.1, clip 1.0) on the
    data x tensor mesh over the CLI's windows: ``(init, losses, final)``."""
    from test_torch_cp_train import _global_batches
    import test_torch_cp_train as CPT

    tx = jax_make_optimizer(
        jax_run_schedule(CLI_LR, total_steps=CLI_STEPS, warmup_steps=0),
        weight_decay=0.1, clip_norm=1.0)
    saved = CPT.B, CPT.S, CPT.STEPS
    CPT.B, CPT.S, CPT.STEPS = CLI_B, S, CLI_STEPS
    try:
        batches = _global_batches(stream, 2, 1)
    finally:
        CPT.B, CPT.S, CPT.STEPS = saved
    return _reference("gpt2", tx, batches, CLI_B * 2)


@pytest.fixture(scope="module")
def tp_train(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    rng = np.random.Generator(np.random.PCG64(11))
    refs, batches, init = {}, {}, {}
    for (arch, opt), steps in CASES.items():
        bs = [rng.integers(0, V, (B, S)).astype(np.int32)
              for _ in range(steps)]
        tx = optax.sgd(0.1) if opt == "sgd" else optax.adam(1e-3)
        init[arch], losses, final = _reference(arch, tx, bs, B)
        refs[(arch, opt)] = (losses, final)
        batches[(arch, opt)] = [torch.from_numpy(b) for b in bs]
    stream = rng.integers(0, V, CLI_STEPS * CLI_B * 2 * S).astype(np.uint16)
    stream.tofile(tmp / "tokens.bin")
    cli_init, cli_losses, cli_final = _cli_reference(stream)
    assert all(np.array_equal(cli_init[k], init["gpt2"][k].numpy())
               for k in cli_init)
    cli = ["--tensor", "2", "--vocab_size", str(V), "--seq_len", str(S),
           "--hidden_dim", "32", "--depth", "2", "--num_heads", "4",
           "--tokens", str(tmp / "tokens.bin"), "--lr", str(CLI_LR),
           "--warmup_steps", "0", "--total_steps", str(CLI_STEPS),
           "--no_profiler", "--attn", "vmem", "--fused", "all",
           "--chunked_ce", "5", "--batch_size", str(CLI_B), "--log_dir",
           str(tmp / "l")]
    payload = {"V": V, "geom": GEOM, "init": init, "batches": batches,
               "cli": cli, "ckpt": str(tmp / "ck")}
    worlds = {}
    for world in (4, 2):
        d = tmp / f"w{world}"
        d.mkdir()
        worlds[world] = _spawn(d, world, {**payload,
                                          "ckpt": str(d / "ck")})
    return refs, (cli_losses, cli_final), worlds


def _close(got, want_losses, want, *, sgd):
    rtol = 1e-5 if sgd else 2e-4
    np.testing.assert_allclose(got["losses"], want_losses, rtol=rtol,
                               atol=1e-5 if sgd else 0)
    assert got["params"].keys() == want.keys()
    for k, w in want.items():
        g = got["params"][k].numpy()
        w = np.asarray(w)
        if not sgd and k.endswith("qkv.bias"):
            # the key bias's gradient is zero in exact arithmetic: Adam
            # turns rounding noise into a full step of either sign, held
            # to the step bound (test_torch_gpt2_train.py's rule)
            assert np.abs(g[1]).max() <= 1.5 * 3 * 1e-3, k
            g, w = g[[0, 2]], w[[0, 2]]
        # Adam moves a zero-initialized element by up to lr a step: its
        # rounding noise is held to the bar times that scale
        atol = 1e-5 if sgd else 2e-4 * 1e-3 * 3
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("world", [4, 2], ids=["data2-tensor2", "tensor2"])
@pytest.mark.parametrize("arch,opt", list(CASES), ids=lambda x: x)
def test_step_matches_the_references_data_x_tensor_mesh(tp_train, world,
                                                        arch, opt):
    refs, _, worlds = tp_train
    got = worlds[world]
    assert got["worlds"] == (world // 2, 2)
    # DDP over the data group, no wrapper with one replica
    assert got[(arch, opt)]["ddp"] == ("DistributedDataParallel"
                                       if world == 4 else "GPT2"
                                       if arch == "gpt2" else "Llama")
    _close(got[(arch, opt)], *refs[(arch, opt)], sgd=opt == "sgd")


def test_cli_fused_chunked_matches_the_reference(tp_train):
    from test_torch_zero1 import assert_lm_close
    import test_torch_zero1 as Z

    _, (want_losses, want), worlds = tp_train
    saved = Z.STEPS, Z.LR
    Z.STEPS, Z.LR = CLI_STEPS, CLI_LR
    try:
        assert_lm_close([worlds[4]["cli"]], want_losses, want)
    finally:
        Z.STEPS, Z.LR = saved


def test_cli_amp_generate_eval(tp_train):
    _, _, worlds = tp_train
    got = worlds[4]["amp"]
    assert len(got["losses"]) == CLI_STEPS and np.isfinite(got["losses"]).all()
    assert "generated tokens: [" in got["out"]
    assert "val_loss:" in got["out"] and "amp: skipped" not in got["out"]


def test_checkpoint_holds_whole_leaves_and_restores(tp_train):
    _, _, worlds = tp_train
    got = worlds[4]
    assert got["restored"]
    shapes = got["saved_shapes"]
    assert shapes["opt.mu.wte"] == (V, 32)
    assert shapes["params.h.0.qkv.weight"] == (96, 32)
    assert shapes["params.h.0.qkv.bias"] == (3, 4, 8)
    assert shapes["params.h.0.mlp_proj.weight"] == (32, 128)
    assert shapes["params.h.0.ln_1.scale"] == (32,)


def test_tensor_refusals():
    from tpudist_torch import train_gpt2
    from tpudist_torch.mesh import RankLayout
    from tpudist_torch.parallel.plan import ParallelPlan
    from tpudist_torch.resilience import elastic

    base = ["--device", "cpu", "--tensor", "2"]
    # --tensor composes with --fsdp, --cp and --shard_opt_state (run in
    # tests/test_torch_tp_fsdp.py, test_torch_tp_cp.py, test_torch_tp_zero1.py)
    for flags in (["--fsdp", "2"], ["--cp", "2"], ["--shard_opt_state"]):
        parser, args = train_gpt2.parse_args([*base, *flags])
        train_gpt2.check_ported(parser, args)
    # --tensor 2 --pipe 2 is ported (tests/test_torch_pp_train.py): in one
    # process the layout needs its 4 ranks
    with pytest.raises(ValueError, match="1 ranks not divisible by the "
                       "fixed axes' product 4"):
        train_gpt2.main([*base, "--pipe", "2"])
    # --experts composes with --tensor (tests/test_torch_ep_train.py runs
    # expert x tensor); beside --fsdp it is not ported yet
    train_gpt2.check_ported(*train_gpt2.parse_args([*base, "--experts",
                                                    "4"]))
    with pytest.raises(NotImplementedError, match=r"#7d \(remainder\)"):
        train_gpt2.main([*base, "--experts", "4", "--fsdp", "2"])
    plan = ParallelPlan(RankLayout(0, 1, 1, tensor=2))
    assert plan.model_axes == {"tensor": 2}
    assert plan.axis_worlds()["tensor_world"] == 2
    assert plan.describe() == ("ParallelPlan(data=1, fsdp=1, pipe=1, "
                               "tensor=2, expert=1)")
    with pytest.raises(ValueError, match="pure-DP.*tensor=2"):
        plan.validate_reduce("bucketed")
    from tpudist_torch.optim import ShardedStateOptimizer, make_optimizer

    zero1 = plan.wrap_zero1(make_optimizer(1e-3))
    assert isinstance(zero1, ShardedStateOptimizer)
    assert zero1.world == 1 and zero1.skip_spec is None
    saved = {"world_size": 2, "tensor_world": 2, "fsdp_world": 1}
    reason = elastic.refusal_reason(saved, {**saved, "tensor_world": 1})
    assert "only the data axis is elastic" in reason
    assert "MeshConfig(fsdp=1, tensor=2, pipe=1, expert=1)" in reason
