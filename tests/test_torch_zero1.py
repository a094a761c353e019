"""ZeRO-1 (``tpudist_torch.optim.shard_state``): each optimizer-state leaf
stored as this data replica's slice, against ``tpudist.optim.shard_state``
and against the replicated step.

- The classification (replicate / shard on a dim / pad to ``[world,
  cols]``) equals the reference's ``_zero1_layout`` on every leaf shape of
  ResNet-18 and GPT-2 (both frameworks' layouts: flax's ``[in, out]`` and
  the port's ``[out, in]``) at world 2, 4 and 8.
- Over 2 gloo ranks, Adam, SGD, Lion, the fused AdamW (its plain version
  on the CPU) with and without a bf16 compute copy, and Adam and the
  fused AdamW (with clipping) behind the ``--amp`` guard: three steps under ZeRO-1 end bit-equal in float32 to
  the replicated run (the update is element-wise, and every rank holds
  the same reduced gradient), on a model with ``shard``, ``pad`` and
  ``replicate`` leaves (a 1-D pad leaf among them: the decay mask reads
  the natural shapes); the pad region of every stored leaf stays zero;
  ZeRO-1 composes with ``reduce="quantized"`` bit for bit too. A NaN in
  one rank's slice alone makes every rank skip the step (the guard's flag
  is summed over the data replicas). The whole
  gathered masters come back through ``state.params()``. Lamb and Muon
  (behind the guard, with clipping) read whole leaves: their sliced state
  is gathered for the update, which is then the replicated one bit for
  bit.
- ``train_gpt2 --shard_opt_state`` on 2 ranks matches the reference's
  step with ``shard_state`` on 2 CPU devices within
  ``test_torch_gpt2_train.py``'s bars (losses 1e-5 relative, parameters
  1e-4 relative plus 1e-4 absolute).
- A checkpoint of a ZeRO-1 state holds one global array per leaf (DTensors
  over the data replicas), and a resume restores it bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tpudist import mesh as jax_mesh
from tpudist import optim as jax_optim
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.models.resnet import resnet18 as jax_resnet18
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.optim import run_schedule as jax_run_schedule
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import lm_loss as jax_lm_loss
from tpudist.train import make_train_step as jax_make_train_step
from tpudist.train import state_shardings_of
from tpudist_torch import optim
from tpudist_torch.interop import gpt2_params_from_flax
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.resnet import resnet18
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _flax_shapes(model, sample):
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), sample,
                                               train=False))["params"]
    return [tuple(x.shape) for x in jax.tree_util.tree_leaves(
        meta.unbox(shapes))]


@pytest.mark.parametrize("world", [2, 4, 8])
def test_classification_equals_the_reference(world):
    shapes = (
        _flax_shapes(jax_resnet18(), jnp.zeros((1, 32, 32, 3)))
        + _flax_shapes(JGPT2(), jnp.zeros((1, 8), jnp.int32))
        + [tuple(p.shape) for p in resnet18(device="meta").parameters()]
        + [tuple(p.shape) for p in GPT2(device="meta").parameters()]
        + [(), (7,), (1030,), (3, 1030), (1031, 3), (4096,)])
    modes = set()
    for shape in shapes:
        ours = optim._zero1_layout(shape, world, 1024)
        assert ours == jax_optim._zero1_layout(shape, world, 1024), shape
        modes.add(ours[0])
    assert modes == {"replicate", "shard", "pad"}


WORKER = r"""
import sys
import torch
import torch.distributed as dist
from torch import nn
from tpudist_torch.amp import skipped_steps
from tpudist_torch.checkpoint import Checkpointer
from tpudist_torch.distributed import init_from_env
from tpudist_torch.optim import make_optimizer, shard_state
from tpudist_torch.train import (
    create_train_state, default_layout, make_train_step)

torch.set_num_threads(1)
out, ck = sys.argv[1], sys.argv[2]
ctx = init_from_env("cpu")
r, w = ctx.rank, ctx.world_size


class Net(nn.Module):
    # leaves at world 2: fc0.weight [41, 37] pad, fc1.weight [1031, 41]
    # pad, fc1.bias [1031] pad (1-D: no decay), head.weight [10, 1031]
    # shard (dim 0), the small biases replicate
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.fc0, self.fc1 = nn.Linear(37, 41), nn.Linear(41, 1031)
        self.head = nn.Linear(1031, 10)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.2)

    def forward(self, x):
        # under a bf16 compute copy the parameters are the copy
        x = x.to(self.fc0.weight.dtype)
        return self.head(torch.tanh(self.fc1(torch.tanh(self.fc0(x))))).float()


g = torch.Generator().manual_seed(1)
batches = [{"image": torch.randn(8, 37, generator=g),
            "label": torch.randint(0, 10, (8,), generator=g)}
           for _ in range(3)]
TXS = {
    "adam": lambda: make_optimizer(1e-2, weight_decay=0.1, clip_norm=0.5),
    "sgd": lambda: make_optimizer(1e-2, optimizer="sgd", weight_decay=0.1),
    "lion": lambda: make_optimizer(1e-3, optimizer="lion"),
    "fused": lambda: make_optimizer(1e-2, fused=True, weight_decay=0.1),
    "fused_bf16": lambda: make_optimizer(1e-2, fused=True, weight_decay=0.1,
                                         compute_dtype=torch.bfloat16),
    "amp": lambda: make_optimizer(1e-2, skip_nonfinite_updates=True),
    "fused_amp": lambda: make_optimizer(1e-2, fused=True, weight_decay=0.1,
                                        clip_norm=0.5,
                                        skip_nonfinite_updates=True),
    "lamb": lambda: make_optimizer(1e-2, optimizer="lamb", weight_decay=0.1),
    "muon": lambda: make_optimizer(1e-2, optimizer="muon", clip_norm=0.5,
                                   skip_nonfinite_updates=True),
}


def run(name, zero, reduce="none"):
    model = Net()
    tx = TXS[name]()
    if zero:
        tx = shard_state(tx, default_layout())
    fused = "optimizer" if name.startswith("fused") else None
    state = create_train_state(model, tx, ddp=reduce == "none")
    step = make_train_step(model, tx, fused=fused, reduce=reduce)
    if step.grad_reducer is not None:
        state.comm_residual = step.grad_reducer.new_residual(
            dict(model.named_parameters()))
    losses = []
    for b in batches:
        state, m = step(state, {k: v.chunk(w)[r] for k, v in b.items()})
        losses.append(float(m["loss"]))
    return state, losses


res = {}
for name in TXS:
    for zero in (False, True):
        state, losses = run(name, zero)
        res[(name, zero)] = {"losses": losses, "params": state.params(),
                             "module": {k: p.detach().clone() for k, p in
                                        state.model.named_parameters()}}
        if zero:
            z = state.opt_state
            res[(name, "modes")] = {k: m[0] for k, m in z.modes.items()}
            pads = {}
            from tpudist_torch.optim import _named_leaves
            for k, (mode, cols) in z.modes.items():
                if mode == "pad":
                    valid = max(0, min(cols, z.params[k].numel() - r * cols))
                    # the stored leaves (a whole-leaf optimizer keeps
                    # the parameter itself whole)
                    kept = [*_named_leaves(z.inner, k)] + (
                        [z.slices[k]] if z.slices[k] is not z.params[k]
                        else [])
                    pads[k] = [t.reshape(-1)[valid:].clone() for t in kept]
            res[(name, "pads")] = pads
for zero in (False, True):
    state, losses = run("adam", zero, "quantized")
    res[("quantized", zero)] = {"losses": losses, "params": state.params()}
# a whole-leaf optimizer's checkpoint round trip
state, _ = run("muon", True)
ckpt = Checkpointer(ck + "_muon")
ckpt.save(state, wait=True)
saved = {k: v.clone() for k, v in state.params().items()}
state2, _ = run("muon", True)
ckpt.restore(state2)
res["restored_muon"] = all(torch.equal(state2.params()[k], v)
                           for k, v in saved.items())
ckpt.close()
# a checkpoint round trip of the fused ZeRO-1 state
state, _ = run("fused", True)
ckpt = Checkpointer(ck)
ckpt.save(state, wait=True)
saved = {k: v.clone() for k, v in state.params().items()}
moments = {k: v.clone() for k, v in state.opt_state.inner.mu.items()}
state2, _ = run("fused", True)
ckpt.restore(state2)
res["restored"] = all(torch.equal(state2.params()[k], v)
                      for k, v in saved.items()) and all(
    torch.equal(state2.opt_state.inner.mu[k], v) for k, v in moments.items())
ckpt.close()
if r == 0:
    from tpudist_torch.checkpoint import read_step
    res["saved_shapes"] = {k: tuple(v.shape) for k, v in
                           read_step(ck, state.step).items()
                           if isinstance(v, torch.Tensor)}
# a NaN in rank 1's slice alone (fc0.weight's last element): the guard's
# flag, each rank's check over its own slices, is summed over the data
# replicas, so both ranks skip (no clip: it would spread the NaN)
for name, guarded in (("amp", lambda: make_optimizer(
        1e-2, skip_nonfinite_updates=True)), ("fused_amp", lambda:
        make_optimizer(1e-2, fused=True, skip_nonfinite_updates=True))):
    model = Net()
    tx = shard_state(guarded(), default_layout())
    params = dict(model.named_parameters())
    st = tx.init(params)
    before = {k: p.detach().clone() for k, p in params.items()}
    grads = {k: torch.full_like(p, 0.01) for k, p in params.items()}
    grads["fc0.weight"].view(-1)[-1] = float("nan")
    tx.step(st, params, grads)
    mine = st.slices["fc0.weight"].view(-1)
    res[(name, "poisoned")] = {
        "skipped": skipped_steps(st),
        "unchanged": all(torch.equal(p, before[k])
                         for k, p in params.items()),
        "nan_here": bool(grads["fc0.weight"].view(-1)[
            r * mine.numel():(r + 1) * mine.numel()].isnan().any())}
every = [None] * w
dist.all_gather_object(every, {k: v for k, v in res.items()
                               if isinstance(k, tuple) and k[1] in (
                                   "pads", "poisoned")})
res["every_pads"] = every
if r == 0:
    torch.save(res, out)
dist.destroy_process_group()
"""


def _free_port() -> int:
    from torch_ports import free_port

    return free_port()


@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero1")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR":
               "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(tmp / "out.pt"),
             str(tmp / "ck")], env=env, cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-4000:]
    return torch.load(tmp / "out.pt", weights_only=False)


NAMES = ["adam", "sgd", "lion", "fused", "fused_bf16", "amp", "fused_amp",
         "lamb", "muon"]


@pytest.mark.parametrize("name", NAMES)
def test_zero1_is_bit_equal_to_the_replicated_step(zero_runs, name):
    rep, zero = zero_runs[(name, False)], zero_runs[(name, True)]
    assert zero["losses"] == rep["losses"]
    for k, p in rep["params"].items():
        assert torch.equal(zero["params"][k], p), k
    for k, p in rep["module"].items():
        # the module's parameters (a bf16 compute copy under fused_bf16)
        assert zero["module"][k].dtype == p.dtype
        assert torch.equal(zero["module"][k], p), k
    assert set(zero_runs[(name, "modes")].values()) == {
        "replicate", "shard", "pad"}


@pytest.mark.parametrize("name", NAMES)
def test_the_pad_region_stays_zero(zero_runs, name):
    for pads in zero_runs["every_pads"]:
        for k, tails in pads[(name, "pads")].items():
            for t in tails:
                assert torch.count_nonzero(t) == 0, k
    # rank 1 holds the tail: 41 * 37 = 1517 = 759 + 758, one padded slot
    assert [t.numel() for t in
            zero_runs["every_pads"][1][(name, "pads")]["fc0.weight"]][0] == 1


@pytest.mark.parametrize("name", ["amp", "fused_amp"])
def test_a_nan_in_one_ranks_slice_skips_every_rank(zero_runs, name):
    """The guard under ZeRO-1: each rank checks its own slices (the fused
    AdamW's check kernel, its plain version here) and the flag is summed
    over the data replicas."""
    seen = [every[(name, "poisoned")] for every in zero_runs["every_pads"]]
    assert [s["nan_here"] for s in seen] == [False, True]
    for s in seen:
        assert s["skipped"] == 1 and s["unchanged"]


def test_zero1_composes_with_the_quantized_reducer(zero_runs):
    rep, zero = zero_runs[("quantized", False)], zero_runs[("quantized", True)]
    assert zero["losses"] == rep["losses"]
    for k, p in rep["params"].items():
        assert torch.equal(zero["params"][k], p), k


def test_whole_leaf_optimizers_restore(zero_runs):
    """Lamb and Muon read whole leaves: ZeRO-1 gathers their sliced state
    for the update (bit-equal above) and a checkpoint restores it."""
    assert zero_runs["restored_muon"]


def test_checkpoint_holds_global_arrays_and_restores(zero_runs):
    assert zero_runs["restored"]
    shapes = zero_runs["saved_shapes"]
    # the pad leaf's moments: [world, cols]; a sharded leaf: its natural
    # shape; the masters likewise
    assert shapes["opt.mu.fc0.weight"] == (2, 759)
    assert shapes["opt.master.fc0.weight"] == (2, 759)
    assert shapes["opt.mu.fc1.weight"] == (2, 21136)
    assert shapes["opt.mu.fc1.bias"] == (2, 516)
    assert shapes["opt.nu.head.weight"] == (10, 1031)


# -- the CLI against the reference's ZeRO-1 step ------------------------------

S, B, V, STEPS, LR = 32, 2, 64, 3, 1e-4
GEOM = dict(vocab_size=V, max_seq_len=S, hidden_dim=32, depth=2, num_heads=4)


def lm_reference(dp, *, fsdp=1, zero1=False, fused=False):
    """The reference's GPT-2 step on ``data x fsdp`` CPU devices, with
    ZeRO-1 (``shard_state`` / ``plan.wrap_zero1``) and FSDP (a plan) as
    asked: ``(init, run)`` as ``test_torch_cp_train._reference``'s."""
    from tpudist.parallel.plan import ParallelPlan as JPlan

    devices = jax.devices()[:dp * fsdp]
    plan = None
    if fsdp > 1:
        plan = JPlan.build(data=dp, fsdp=fsdp, devices=devices)
        mesh = plan.mesh
    else:
        mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(data=dp),
                                    devices=devices)
    model = JGPT2(**GEOM, attn_impl="xla")
    tx = jax_make_optimizer(
        jax_run_schedule(LR, total_steps=STEPS, warmup_steps=0),
        weight_decay=0.1, clip_norm=1.0, fused=fused)
    if zero1:
        tx = plan.wrap_zero1(tx) if plan is not None else \
            jax_optim.shard_state(tx, mesh)
    state = jax_create_train_state(
        model, 0, jnp.zeros((B * dp * fsdp, S), jnp.int32), tx, mesh,
        plan=plan)
    step = jax_make_train_step(
        model, tx, mesh, loss_fn=jax_lm_loss, input_key="tokens",
        label_key="tokens", fused="optimizer" if fused else None,
        state_sharding=state_shardings_of(state), plan=plan)

    def params(st):
        return gpt2_params_from_flax(jax.tree_util.tree_map(
            np.asarray, meta.unbox(st.params)))

    def run(batches):
        st, losses = state, []
        for batch in batches:
            st, metrics = step(st, {"tokens": batch})
            losses.append(float(metrics["loss"]))
        return losses, params(st)

    return params(state), run


LM_WORKER = """
import sys
import torch
import torch.distributed as dist
import tpudist_torch.train_gpt2 as TG

out, init = sys.argv[1], sys.argv[2]
state_dict = torch.load(init)
build = TG.build_model

def build_loaded(*args, **kw):
    model = build(*args, **kw)
    model.load_state_dict(state_dict)
    return model

TG.build_model = build_loaded
# the CLI ends its world on return; the sharded masters are gathered first
destroy, dist.destroy_process_group = dist.destroy_process_group, lambda: None
state, losses = TG.main(["--device", "cpu", *sys.argv[3:]])
params = state.params()
destroy()
torch.save({"losses": losses, "params": params}, out)
"""


def _launch_lm(tmp_path, world, argv):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR":
               "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "1"}
        out = tmp_path / f"lm_r{rank}.pt"
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", LM_WORKER, str(out),
             str(tmp_path / "init.pt"), *argv], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def run_lm_cli(tmp_path, world, flags, replicas, *, zero1=False, fsdp=1,
               fused=False):
    """The port's ``train_gpt2`` CLI in a gloo world of ``world`` ranks
    with ``flags`` and the reference on the same windows: returns
    ``(ranks' results, reference losses, reference parameters)``."""
    from test_torch_cp_train import _collect, _global_batches

    rng = np.random.Generator(np.random.PCG64(7))
    stream = rng.integers(0, V, STEPS * B * replicas * S).astype(np.uint16)
    stream.tofile(tmp_path / "tokens.bin")
    argv = ["--vocab_size", str(V), "--seq_len", str(S), "--hidden_dim",
            str(GEOM["hidden_dim"]), "--depth", str(GEOM["depth"]),
            "--num_heads", str(GEOM["num_heads"]), "--tokens",
            str(tmp_path / "tokens.bin"), "--lr", str(LR), "--warmup_steps",
            "0", "--total_steps", str(STEPS), "--no_profiler", "--attn",
            "xla", "--batch_size", str(B), "--log_dir", str(tmp_path / "l"),
            *flags]
    init, reference = lm_reference(replicas // fsdp, fsdp=fsdp, zero1=zero1,
                                   fused=fused)
    torch.save(init, tmp_path / "init.pt")
    procs = _launch_lm(tmp_path, world, argv)
    want_losses, want = reference(_global_batches(stream, replicas, 1))
    return _collect(procs), want_losses, want


def assert_lm_close(ranks, want_losses, want):
    """``test_torch_gpt2_train.py``'s bars, its qkv key-bias slice (zero
    gradient in exact arithmetic) held to the step bound."""
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-5)
        assert r["params"].keys() == want.keys()
        for k, w in want.items():
            g, w = r["params"][k].numpy(), w.numpy()
            if k.endswith("qkv.bias"):
                assert np.abs(g[1]).max() <= 1.5 * STEPS * LR, k
                g, w = g[[0, 2]], w[[0, 2]]
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["adamw", "fused"])
def test_cli_shard_opt_state_matches_the_reference(tmp_path, fused):
    flags = ["--shard_opt_state"] + (["--fused", "optimizer"] if fused else [])
    ranks, want_losses, want = run_lm_cli(tmp_path, 2, flags, 2, zero1=True,
                                          fused=fused)
    assert_lm_close(ranks, want_losses, want)
