"""FSDP over ``data x fsdp`` (``tpudist_torch.parallel.fsdp`` through a
``ParallelPlan``) against ``tpudist.parallel.fsdp`` / ``.plan``.

- ``fsdp_spec`` is the reference's rule on the same shapes.
- ResNet (8 filters, SGD 0.01 with momentum 0.9, 3 steps of 32 rows) under
  ``fsdp 2`` on 2 gloo ranks, in float64 on both sides: the losses, the
  parameters and the BN statistics within ``test_torch_dp.py``'s float64
  bars (1e-6 relative, plus 1e-6 absolute) of the reference's plan-built
  step on 2 CPU devices and of the port's own replicated (DDP) run.
  Float64 for the reason ``test_torch_dp_reduce.py`` gives: in float32
  the BN statistics' cancellation turns the frameworks' other summation
  orders into 1.4e-4 on a conv weight by the third step (measured).
- ``train_gpt2 --fsdp 2`` on 2 ranks and on ``data 2 x fsdp 2`` (4 ranks)
  matches the reference's plan (``test_torch_gpt2_train.py``'s bars), and
  so does ``main --fsdp 2`` against the port's replicated CLI run.
- The bytes each rank holds (its parameter shards and Adam's moments)
  equal ``memory.per_device_bytes`` under the plan's placement records,
  and the reference's ``per_device_bytes`` under its ``fsdp_shardings``
  for the flax model's shapes.
- The fused AdamW under FSDP with a bf16 copy: the parameters FSDP2
  gathers (its ``MixedPrecisionPolicy`` cast of the float32 master shard
  the kernel wrote) are bit-equal to ``master.to(bf16)``, the copy the
  kernel itself writes on the replicated path.
- ``--fsdp`` with ``--cp`` and an explicit ``--reduce`` with ``--fsdp``
  raise.
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

from tpudist import memory as jax_memory
from tpudist.data.cifar import synthetic_cifar, to_tensor
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.models.resnet import resnet18 as jax_resnet18
from tpudist.parallel import fsdp as jax_fsdp
from tpudist.parallel.plan import ParallelPlan as JPlan
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import make_train_step as jax_make_train_step
from tpudist.train import state_shardings_of
from tpudist_torch.parallel.fsdp import fsdp_spec

from test_torch_dp_reduce import _params64
from test_torch_zero1 import GEOM, assert_lm_close, run_lm_cli
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
STEPS, ROWS = 3, 32


@pytest.mark.parametrize("shape,n", [
    ((64, 768), 2), ((768, 2304), 4), ((50257, 768), 2), ((3, 3, 16, 8), 2),
    ((8, 16, 3, 3), 2), ((1000,), 2), ((999, 5), 3), ((33, 31), 2),
    ((4096,), 8), ((12, 64, 64), 4), ((), 2), ((1024, 1024), 1)])
def test_fsdp_spec_is_the_references_rule(shape, n):
    ref = tuple(jax_fsdp.fsdp_spec(shape, n))
    ours = fsdp_spec(shape, n)
    # the reference's P() spells "replicated" as an empty spec too
    assert ours == tuple(ref) or (not any(ref) and ours == ())


WORKER = r"""
import sys
import torch
import torch.distributed as dist
from tpudist_torch.distributed import init_from_env
from tpudist_torch.memory import per_device_bytes, plan_placements
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.resnet import resnet18
from tpudist_torch.optim import make_optimizer
from tpudist_torch.parallel.plan import ParallelPlan
from tpudist_torch.train import create_train_state, make_train_step

torch.set_num_threads(1)
src, out = sys.argv[1], sys.argv[2]
ctx = init_from_env("cpu")
r, w = ctx.rank, ctx.world_size
data = torch.load(src)
plan = ParallelPlan.build(data=-1, fsdp=2)
res = {"describe": plan.describe(), "worlds": plan.axis_worlds()}


def run(plan):
    model = resnet18(num_filters=8, device="cpu", dtype=torch.float64)
    model.load_state_dict(data["resnet"])
    model = model.to(torch.float64)
    tx = make_optimizer(0.01, optimizer="sgd")
    state = create_train_state(model, tx, plan)
    step = make_train_step(model, tx, plan=plan)
    losses = []
    for b in data["images"]:
        b = {k: v.double() if v.is_floating_point() else v
             for k, v in b.items()}
        state, m = step(state, {k: v.chunk(w)[r] for k, v in b.items()})
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": state.params(),
            "stats": state.batch_stats()}


res["fsdp"] = run(plan)
res["ddp"] = run(None)

# channels-last conv weights (a ResNet's on the card) are sharded too
model = resnet18(num_filters=8, device="cpu")
for p in model.parameters():
    if p.ndim == 4 and p.shape[-1] > 1:
        p.data = p.data.contiguous(memory_format=torch.channels_last)
state = create_train_state(model, make_optimizer(1e-3), plan)
res["channels_last_sharded"] = sum(
    hasattr(p, "to_local") for p in model.parameters())

# the bytes a rank holds: its shards and Adam's moments of them
geom = dict(vocab_size=64, max_seq_len=32, hidden_dim=32, depth=2,
            num_heads=4)
model = GPT2(**geom, device="cpu")
full = {k: p.detach().clone() for k, p in model.named_parameters()}
state = create_train_state(model, make_optimizer(1e-3), plan)
local = sum(p.to_local().numel() * 4 if hasattr(p, "to_local") else
            p.numel() * 4 for p in model.parameters())
moments = sum(t.numel() * 4 for d in (state.opt_state.mu, state.opt_state.nu)
              for t in d.values())
recs = plan_placements(full, fsdp=2)
res["bytes"] = {"params": local, "moments": moments,
                "planned": per_device_bytes(full, recs),
                "global": sum(t.numel() * 4 for t in full.values())}

# the fused AdamW's copy: FSDP2's bf16 cast of the master shards
model = GPT2(**geom, device="cpu")
tx = make_optimizer(1e-2, fused=True, weight_decay=0.1,
                    compute_dtype=torch.bfloat16)
state = create_train_state(model, tx, plan)
step = make_train_step(model, tx, plan=plan, fused="optimizer",
                       loss_fn=__import__("tpudist_torch.train").train.lm_loss,
                       input_key="tokens", label_key="tokens")
g = torch.Generator().manual_seed(3)
for _ in range(2):
    toks = torch.randint(0, 64, (4, 32), generator=g)
    state, m = step(state, {"tokens": toks.chunk(w)[r]})
masters = state.params()
# what the forward reads: each module's parameters as FSDP gathered them
# (hooks registered after FSDP's run inside its gather)
gathered = {}


def capture(prefix):
    def hook(module, args):
        for k, p in module.named_parameters(recurse=False):
            gathered[prefix + k] = p.detach().clone()
    return hook


for name, mod in model.named_modules():
    mod.register_forward_pre_hook(capture(name + "." if name else ""))
with torch.no_grad():
    model(toks.chunk(w)[r])
res["copy"] = {k: (gathered[k].dtype, torch.equal(
    gathered[k], masters[k].to(torch.bfloat16))) for k in masters}
if r == 0:
    torch.save(res, out)
dist.destroy_process_group()
"""


def _free_port() -> int:
    from torch_ports import free_port

    return free_port()


def _images():
    data = to_tensor(synthetic_cifar(STEPS * ROWS, num_classes=100, seed=3))
    return [{k: np.asarray(v[i * ROWS:(i + 1) * ROWS])
             for k, v in data.items()} for i in range(STEPS)]


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    images = _images()
    sgd = optax.sgd(0.01, momentum=0.9)
    jm = jax_resnet18(num_filters=8)
    plan = JPlan.build(data=1, fsdp=2, devices=jax.devices()[:2])
    state = jax_create_train_state(jm, 0, jnp.zeros((2, 32, 32, 3)), sgd,
                                   plan.mesh, plan=plan)
    as64 = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), t)
    p0, s0 = as64(state.params), as64(state.batch_stats)
    init = _params64(p0, s0)
    with jax.enable_x64(True):
        jm64 = jm.clone(dtype=jnp.float64)
        state = jax_create_train_state(jm64, 0, jnp.zeros((2, 32, 32, 3)),
                                       sgd, plan.mesh, plan=plan)
        sh = state_shardings_of(state)
        params = jax.device_put(p0, sh.params)
        state = state.replace(params=params, opt_state=sgd.init(params),
                              batch_stats=jax.device_put(s0, sh.batch_stats))
        step = jax_make_train_step(jm64, sgd, plan.mesh, plan=plan,
                                   state_sharding=state_shardings_of(state))
        losses = []
        for b in images:
            b = {"image": b["image"].astype(np.float64), "label": b["label"]}
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        ref = (losses, _params64(as64(state.params),
                                 as64(state.batch_stats)))
    torch.save({"resnet": init, "images": [
        {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
        for b in images]}, tmp / "in.pt")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR":
               "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(tmp / "in.pt"),
             str(tmp / "out.pt")], env=env, cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-4000:]
    return ref, torch.load(tmp / "out.pt", weights_only=False)


def _close(got, want_losses, want):
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-6)
    have = {**got["params"], **got["stats"]}
    assert have.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(have[k].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_fsdp_resnet_matches_the_references_plan(fsdp_runs):
    ref, got = fsdp_runs
    _close(got["fsdp"], *ref)
    assert got["describe"] == ("ParallelPlan(data=1, fsdp=2, pipe=1, "
                               "tensor=1, expert=1)")
    assert got["worlds"] == JPlan.build(
        data=1, fsdp=2, devices=jax.devices()[:2]).axis_worlds()


def test_channels_last_weights_are_sharded(fsdp_runs):
    """FSDP2 shards contiguous parameters only: channels-last conv
    weights are made contiguous first, not refused."""
    _, got = fsdp_runs
    assert got["channels_last_sharded"] > 0


def test_fsdp_resnet_matches_the_replicated_run(fsdp_runs):
    _, got = fsdp_runs
    ddp = got["ddp"]
    _close(got["fsdp"], ddp["losses"], {**ddp["params"], **ddp["stats"]})


def test_per_device_bytes_equal_the_plan_and_the_reference(fsdp_runs):
    _, got = fsdp_runs
    b = got["bytes"]
    assert b["params"] == b["planned"] < b["global"]
    assert b["moments"] == 2 * b["planned"]
    jm = JGPT2(**GEOM, attn_impl="xla")
    shapes = meta.unbox(jax.eval_shape(
        lambda: jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                        train=False))["params"])
    plan = JPlan.build(data=1, fsdp=2, devices=jax.devices()[:2])
    want = jax_memory.per_device_bytes(
        shapes, jax_fsdp.fsdp_shardings(shapes, plan.mesh))
    assert b["planned"] == want


def test_fused_copy_is_fsdps_bf16_cast_of_the_master(fsdp_runs):
    _, got = fsdp_runs
    assert got["copy"]
    for k, (dtype, equal) in got["copy"].items():
        assert dtype == torch.bfloat16 and equal, k


@pytest.mark.parametrize("world", [2, 4], ids=["fsdp2", "data2-fsdp2"])
def test_cli_fsdp_matches_the_references_plan(tmp_path, world):
    ranks, want_losses, want = run_lm_cli(
        tmp_path, world, ["--fsdp", "2"], world, fsdp=2)
    assert_lm_close(ranks, want_losses, want)


def _spawn_main(tmp_path, tag, flags):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR":
               "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpudist_torch.main", "--device", "cpu",
             "--model", "resnet18", "--dataset", "synthetic",
             "--synthetic_size", "48", "--batch_size", "4", "--epochs", "1",
             "--no_profiler", "--JobID", tag, "--log_dir", str(tmp_path),
             *flags], env=env, cwd=tmp_path, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-4000:]
        outs.append(out.decode())
    return outs


def test_main_fsdp_trains_as_the_replicated_cli(tmp_path):
    _spawn_main(tmp_path, "F", ["--fsdp", "2"])
    _spawn_main(tmp_path, "D", [])

    def losses(tag):
        rows = (tmp_path / f"{tag}_4_0.log").read_text().splitlines()
        return [float(r.split("\t")[3]) for r in rows[1:-1]]

    assert len(losses("F")) == 1
    np.testing.assert_allclose(losses("F"), losses("D"), rtol=1e-5)


def test_fsdp_refusals():
    from tpudist_torch import train_gpt2
    from tpudist_torch.main import main
    from tpudist_torch.mesh import MeshConfig
    from tpudist_torch.parallel.fsdp import compose_fsdp
    from tpudist_torch.parallel.plan import ParallelPlan

    with pytest.raises(SystemExit, match="--fsdp does not compose with --cp"):
        train_gpt2.main(["--device", "cpu", "--fsdp", "2", "--cp", "2"])
    with pytest.raises(ValueError, match="pure-DP"):
        main(["--device", "cpu", "--fsdp", "2", "--reduce", "bucketed"])
    with pytest.raises(ValueError, match="fsdp does not compose with seq"):
        MeshConfig(fsdp=2, seq=2)
    # fsdp x tensor composes (tests/test_torch_tp_fsdp.py runs it): the
    # layout wants its ranks, and compose_fsdp is the plan's FSDP
    assert MeshConfig(fsdp=2, tensor=2).axis_sizes(8)["data"] == 2
    with pytest.raises(ValueError, match="wants 4 ranks"):
        ParallelPlan.build(data=1, fsdp=2, tensor=2)
    # a pipe axis is ported (tests/test_torch_pp_train.py): one rank
    # cannot hold two stages; FSDP beside it is not ported yet
    with pytest.raises(ValueError, match="1 ranks not divisible"):
        ParallelPlan.build(pipe=2)
    with pytest.raises(NotImplementedError, match=r"Queue 1 #7c \(remainder"):
        ParallelPlan.build(fsdp=2, pipe=2)
    # an expert axis is ported (tests/test_torch_ep_train.py): one rank
    # cannot hold two expert ranks; FSDP beside it is not ported yet
    with pytest.raises(ValueError, match="1 ranks not divisible"):
        ParallelPlan.build(expert=2)
    with pytest.raises(NotImplementedError, match=r"Queue 1 #7d"):
        MeshConfig(data=1, fsdp=2, expert=2).axis_sizes(4)
    from tpudist_torch.parallel.fsdp import apply_fsdp

    assert compose_fsdp is apply_fsdp


@pytest.mark.parametrize("fsdp,data,zero1", [
    (2, 1, False), (4, 1, False), (2, 2, False), (1, 4, True)],
    ids=["fsdp2", "fsdp4", "data2-fsdp2", "zero1-data4"])
def test_budget_under_a_plan_is_the_references(fsdp, data, zero1):
    """``train_state_budget(plan=)``: the parameters, gradients, optimizer
    state and activation estimate per chip equal the reference's under
    its plan (its Adam count, an int32 the port keeps on the host, aside).
    The port does not lay ZeRO-1 over FSDP's shards (the reference's
    ``(fsdp, data)`` mirror overlay): with both axes above 1 the moments
    of a sharded leaf stay at FSDP's share (ROADMAP #7a)."""
    import types

    from tpudist.optim import make_optimizer as jax_make_optimizer
    from tpudist_torch import memory as M
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.optim import make_optimizer, shard_state

    plan = JPlan.build(data=data, fsdp=fsdp,
                       devices=jax.devices()[:data * fsdp])
    jtx = jax_make_optimizer(1e-3)
    tx = make_optimizer(1e-3)
    if zero1:
        jtx = plan.wrap_zero1(jtx)
        tx = shard_state(tx, world=data, rank=0)
    want = jax_memory.train_state_budget(
        JGPT2(**GEOM, attn_impl="xla"), jtx, jnp.zeros((1, 8), jnp.int32),
        batch=8, seq=32, plan=plan, hbm_budget_bytes=1 << 34)
    got = M.train_state_budget(
        lambda d: GPT2(**GEOM, attn_impl="xla", device=d), tx, batch=8,
        seq=32,
        plan=types.SimpleNamespace(data=data, fsdp=fsdp),
        hbm_budget_bytes=1 << 34)
    for k in ("params_bytes", "grad_bytes", "activation_bytes_est",
              "n_params"):
        assert got[k] == want[k], k
    count = 4  # the reference's int32 Adam count
    assert got["opt_state_bytes_per_chip"] == \
        want["opt_state_bytes_per_chip"] - count
    assert got["opt_state_bytes_global"] == \
        want["opt_state_bytes_global"] - count
