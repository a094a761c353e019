"""The explicit gradient reducer (``tpudist_torch.parallel.dp``, the
train step's ``reduce=``) over 2 gloo ranks against the reference's
``make_train_step(reduce=...)`` over 2 CPU devices, from the same weights
(the flax init carried over) and the same batches (rank r, device r: the
r-th half).

- ResNet (8 filters, SGD 0.01 with momentum 0.9, 3 steps of 32 rows,
  16 a rank) in float64 on both sides: ``bucketed`` equals the
  reference's trajectory within ``test_torch_dp.py``'s float64 bars
  (losses 1e-6 relative; parameters and BN statistics 1e-6 relative plus
  1e-6 absolute; measured 1.6e-7), and its running statistics are the
  mean of LOCAL batch statistics (they differ from the cross-replica
  ``none`` run's). The buckets are float32 on both sides, as the
  reference flattens them. Float64 and 16 rows a rank, because local
  batch statistics are ill-conditioned at a few rows: at 4 rows a rank
  the last stages normalise a handful of values, and a float32 rounding
  of one gradient (one ulp apart between XLA and PyTorch) grew from 4e-8
  to 4e-3 in three steps in float64 itself (measured; 2e-7 at 16 rows).
- The reference's BN-free MLP (13 -> 37 -> 10, bucket size 64): Adam 1e-2,
  4 steps; ``bucketed`` within 1e-5 of the reference's; ``quantized``
  tracks the float32 trajectory within the reference's own bars
  (``test_dp_equivalence.py``: rtol 0.05, atol 0.02), also with
  ``grad_accum 4`` (``reductions_per_step == 5``), as the reference's
  quantized run does.
- ``comm_stats`` shows at least 3x compression; a NaN gradient stays
  non-finite through the quantized path; the refusals raise; the CLI
  runs ``--reduce quantized`` on 2 gloo ranks and writes its TSV.
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
from flax import linen as fnn

from tpudist import mesh as mesh_lib
from tpudist.data.cifar import synthetic_cifar, to_tensor
from tpudist.models import resnet18 as jax_resnet18
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import make_train_step as jax_make_train_step
from tpudist_torch import allreduce as comm
from tpudist_torch.interop import resnet_params_from_flax
from tpudist_torch.mesh import RankLayout
from tpudist_torch.parallel import dp
from tpudist_torch.parallel.plan import ParallelPlan
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
STEPS, ROWS = 3, 32

WORKER = r"""
import sys
import torch
import torch.distributed as dist
from torch import nn
from tpudist_torch.distributed import init_from_env
from tpudist_torch.models.resnet import resnet18
from tpudist_torch.optim import make_optimizer
from tpudist_torch.train import create_train_state, make_train_step

torch.set_num_threads(1)
src, out = sys.argv[1], sys.argv[2]
ctx = init_from_env("cpu")
r, w = ctx.rank, ctx.world_size
data = torch.load(src)


class Mlp(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc0, self.fc1 = nn.Linear(13, 37), nn.Linear(37, 10)

    def forward(self, x):
        return self.fc1(torch.relu(self.fc0(x)))


def run(model, tx, batches, reduce, accum=1, bucket=None):
    dtype = next(model.parameters()).dtype
    state = create_train_state(model, tx, ddp=reduce == "none")
    step = make_train_step(model, tx, reduce=reduce, grad_accum=accum,
                           reduce_bucket_size=bucket)
    if step.grad_reducer is not None:
        state.comm_residual = step.grad_reducer.new_residual(
            dict(model.named_parameters()))
    losses = []
    for b in batches:
        half = {k: (v.to(dtype) if v.is_floating_point() else v).chunk(w)[r]
                for k, v in b.items()}
        state, m = step(state, half)
        losses.append(float(m["loss"]))
    return state, losses, step


res = {}
for reduce in ("bucketed", "none"):
    model = resnet18(num_filters=8, device="cpu", dtype=torch.float64)
    model.load_state_dict(data["resnet"])
    model = model.to(torch.float64)
    state, losses, _ = run(model, make_optimizer(0.01, optimizer="sgd"),
                           data["images"], reduce)
    res[f"resnet_{reduce}"] = {"losses": losses, "params": state.params(),
                               "stats": state.batch_stats()}
for reduce, accum in (("bucketed", 1), ("quantized", 1), ("quantized", 4)):
    model = Mlp()
    model.load_state_dict(data["mlp"])
    state, losses, step = run(model, make_optimizer(1e-2), data["mlp_batches"],
                              reduce, accum, bucket=64)
    res[f"mlp_{reduce}_{accum}"] = {
        "losses": losses, "params": state.params(),
        "stats": step.comm_stats(dict(model.named_parameters())),
        "residual": state.comm_residual}
every = [None] * w
dist.all_gather_object(every, {k: v["params"] for k, v in res.items()})
res["every_params"] = every
if r == 0:
    torch.save(res, out)
dist.destroy_process_group()
"""


def _free_port() -> int:
    from torch_ports import free_port

    return free_port()


def _spawn(args, world, tmp_path, *, module=False):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": str(REPO),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, *args], env=env, cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out.decode())
        assert p.returncode == 0, out.decode()[-4000:]
    return outs


class _TinyMlp(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        return fnn.Dense(10)(fnn.relu(fnn.Dense(37)(x)))


def _mlp_batches(n_steps, batch=32, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(batch, 13)).astype(np.float32),
             "label": (rng.random(batch) * 10).astype(np.int32)}
            for _ in range(n_steps)]


def _images(rows=ROWS):
    data = to_tensor(synthetic_cifar(STEPS * rows, num_classes=100, seed=3))
    return [{k: np.asarray(v[i * rows:(i + 1) * rows])
             for k, v in data.items()} for i in range(STEPS)]


def _params64(params, stats):
    """``resnet_params_from_flax`` keeping float64 (it casts to float32)."""
    from tpudist_torch import interop

    f32 = interop._f32
    interop._f32 = lambda a: torch.from_numpy(np.array(a, np.float64))
    try:
        return resnet_params_from_flax(params, stats)
    finally:
        interop._f32 = f32


def _jax_run(model, tx, sample, batches, mesh, **kw):
    state = jax_create_train_state(model, 0, sample, tx, mesh)
    step = jax_make_train_step(model, tx, mesh, **kw)
    if step.grad_reducer is not None:
        state = step.grad_reducer.attach_residual(state)
    losses = []
    for b in batches:
        state, m = step(state, step.stage(b))
        losses.append(float(m["loss"]))
    return state, losses, step


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_reduce")
    mesh = mesh_lib.create_mesh(devices=jax.devices()[:2])
    images = _images()
    ref = {}
    jm = jax_resnet18(num_filters=8)
    sgd = optax.sgd(0.01, momentum=0.9)
    init_state = jax_create_train_state(jm, 0, jnp.zeros((1, 32, 32, 3)),
                                        sgd, mesh)
    as64 = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), t)
    p0, s0 = as64(init_state.params), as64(init_state.batch_stats)
    with jax.enable_x64(True):
        jm64 = jm.clone(dtype=jnp.float64)
        js = jax_create_train_state(jm64, 0, jnp.zeros((1, 32, 32, 3)), sgd,
                                    mesh)
        js = js.replace(params=jax.device_put(p0),
                        batch_stats=jax.device_put(s0),
                        opt_state=sgd.init(jax.device_put(p0)))
        jstep = jax_make_train_step(jm64, sgd, mesh, reduce="bucketed")
        jl = []
        for b in images:
            b = {"image": b["image"].astype(np.float64), "label": b["label"]}
            js, m = jstep(js, jstep.stage(b))
            jl.append(float(m["loss"]))
        ref["resnet"] = (jl, _params64(as64(js.params),
                                       as64(js.batch_stats)))
    resnet_init = _params64(p0, s0)
    mlp_batches = _mlp_batches(4)
    for reduce, accum in (("none", 1), ("bucketed", 1), ("quantized", 1),
                          ("none", 4), ("quantized", 4)):
        _, losses, _ = _jax_run(_TinyMlp(), optax.adam(1e-2),
                                jnp.zeros((1, 13)), mlp_batches, mesh,
                                reduce=reduce, grad_accum=accum,
                                reduce_bucket_size=64)
        ref[f"mlp_{reduce}_{accum}"] = losses
    mstate = jax_create_train_state(_TinyMlp(), 0, jnp.zeros((1, 13)),
                                    optax.adam(1e-2), mesh)
    p = jax.tree_util.tree_map(np.asarray, mstate.params)
    # the outer Dense(10) is built first: Dense_0 is the head
    mlp_init = {
        "fc0.weight": torch.from_numpy(p["Dense_1"]["kernel"].T.copy()),
        "fc0.bias": torch.from_numpy(p["Dense_1"]["bias"].copy()),
        "fc1.weight": torch.from_numpy(p["Dense_0"]["kernel"].T.copy()),
        "fc1.bias": torch.from_numpy(p["Dense_0"]["bias"].copy())}
    def tensors(batches):
        return [{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
                for b in batches]

    torch.save({"resnet": resnet_init, "images": tensors(images),
                "mlp": mlp_init, "mlp_batches": tensors(mlp_batches)},
               tmp / "in.pt")
    script = tmp / "worker.py"
    script.write_text(WORKER)
    _spawn([str(script), str(tmp / "in.pt"), str(tmp / "out.pt")], 2, tmp)
    return ref, torch.load(tmp / "out.pt")


def test_bucketed_resnet_matches_the_references_trajectory(runs):
    ref, got = runs
    want_losses, want = ref["resnet"]
    ours = got["resnet_bucketed"]
    np.testing.assert_allclose(ours["losses"], want_losses, rtol=1e-6)
    have = {**ours["params"], **ours["stats"]}
    assert have.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(have[k].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_bucketed_keeps_batchnorm_statistics_local(runs):
    """The reference's explicit path takes each replica's batch
    statistics (checked above against it); the cross-replica ``none``
    run's differ: its first step normalizes by the global batch."""
    _, got = runs
    local, glob = got["resnet_bucketed"], got["resnet_none"]
    assert local["losses"][0] != glob["losses"][0]
    assert not torch.equal(local["stats"]["bn_init.var"],
                           glob["stats"]["bn_init.var"])


def test_replicas_hold_identical_parameters(runs):
    _, got = runs
    a, b = got["every_params"]
    for run in a:
        for k in a[run]:
            assert torch.equal(a[run][k], b[run][k]), (run, k)


def test_mlp_bucketed_and_quantized_track_fp32(runs):
    ref, got = runs
    np.testing.assert_allclose(got["mlp_bucketed_1"]["losses"],
                               ref["mlp_bucketed_1"], rtol=1e-5)
    np.testing.assert_allclose(ref["mlp_none_1"], ref["mlp_bucketed_1"],
                               rtol=2e-5)
    for accum in (1, 4):
        np.testing.assert_allclose(got[f"mlp_quantized_{accum}"]["losses"],
                                   ref[f"mlp_none_{accum}"], rtol=0.05,
                                   atol=0.02)
        np.testing.assert_allclose(ref[f"mlp_quantized_{accum}"],
                                   ref[f"mlp_none_{accum}"], rtol=0.05,
                                   atol=0.02)
    assert got["mlp_quantized_4"]["stats"]["reductions_per_step"] == 5
    assert got["mlp_quantized_1"]["residual"] is not None
    assert got["mlp_bucketed_1"]["residual"] is None


def test_comm_stats_compress_at_least_3x(runs):
    _, got = runs
    stats = got["mlp_quantized_1"]["stats"]
    assert stats["fp32_bytes_per_step"] >= 3 * stats["bytes_per_step"]
    from tpudist_torch.models.resnet import resnet18

    params = dict(resnet18(device="meta").named_parameters())
    red = dp.GradReducer(None, "quantized", ring=comm.LoopbackRing(4))
    s = red.comm_stats(params, grad_accum=2)
    assert s["reductions_per_step"] == 3 and s["world"] == 4
    assert s["fp32_bytes_per_step"] >= 3 * s["bytes_per_step"]
    assert s["implicit_fp32_bytes_per_step"] == red.layout_for(
        params).wire_bytes("bucketed")


def test_nan_gradient_stays_nonfinite_through_the_quantized_path():
    ring = comm.LoopbackRing(2)
    red = dp.GradReducer(None, "quantized", ring=ring, bucket_size=16)
    layout = comm.BucketLayout({"w": torch.zeros(100)}, 2, 16)
    b = torch.randn(2, layout.n_buckets, layout.bucket_size)
    b[1, 0, 3] = float("nan")
    mean, res = red.reduce(b, torch.zeros_like(b), layout, 0, 0)
    assert not torch.isfinite(mean[0]).all() and not torch.isfinite(
        mean[1]).all()
    assert not torch.isfinite(res[1]).all()


def test_resolve_method_and_refusals(monkeypatch):
    one = RankLayout(0, 1, 1)
    two = RankLayout(0, 2, 1)
    for m in ("none", "bucketed", "quantized", "auto"):
        assert dp.resolve_method(m, one) == "none"
    assert dp.resolve_method("bucketed", two) == "bucketed"
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert dp.resolve_method("auto", two) == "none"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert dp.resolve_method("auto", two) == "quantized"
    fsdp = RankLayout(0, 1, 1, fsdp=2)
    assert dp.resolve_method("auto", fsdp) == "none"
    with pytest.raises(ValueError, match="fsdp=2"):
        dp.resolve_method("quantized", fsdp)
    with pytest.raises(ValueError, match="seq=2"):
        dp.resolve_method("bucketed", RankLayout(0, 2, 2))
    with pytest.raises(ValueError, match="reduce must be one of"):
        dp.resolve_method("int4", two)
    with pytest.raises(ValueError, match="fsdp=2"):
        ParallelPlan(fsdp).validate_reduce("bucketed")
    ParallelPlan(fsdp).validate_reduce("auto")
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        dp.make_divergence_probe()


def test_cli_reduce_with_fsdp_raises():
    from tpudist_torch.main import main

    with pytest.raises(ValueError, match="pure-DP"):
        main(["--device", "cpu", "--fsdp", "2", "--reduce", "quantized"])


def test_cli_reduce_quantized_on_two_gloo_ranks_writes_its_tsv(tmp_path):
    _spawn(["-m", "tpudist_torch.main", "--device", "cpu", "--model",
            "resnet18", "--dataset", "synthetic", "--synthetic_size", "48",
            "--batch_size", "4", "--epochs", "1", "--no_profiler",
            "--reduce", "quantized", "--JobID", "Q", "--log_dir",
            str(tmp_path)], 2, tmp_path)
    rows = (tmp_path / "Q_4_0.log").read_text().splitlines()
    assert rows[0].split("\t")[:2] == ["datetime", "g_step"]
    assert rows[1].split("\t")[1] == "10"
    assert rows[-1].startswith("TrainTime")


def test_reduced_gradients_take_their_parameters_layout():
    """The buckets flatten each leaf in its logical order; the optimizer
    must get each gradient back in its parameter's layout (the fused
    AdamW on the card refuses another): a channels-last conv weight's
    gradient comes back channels-last."""
    from torch import nn

    from tpudist_torch.optim import Optimizer
    from tpudist_torch.train import create_train_state, make_train_step

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(3, 4, 3)
            self.conv.weight.data = self.conv.weight.data.contiguous(
                memory_format=torch.channels_last)

        def forward(self, x):
            return self.conv(x).mean((2, 3))

    seen = {}

    class Spy(Optimizer):
        def init(self, params):
            return type("S", (), {"count": 0})()

        def _update(self, state, params, grads, put):
            seen.update({k: (g.stride(), params[k].stride())
                         for k, g in grads.items()})

    model, tx = Net(), Spy()
    reducer = dp.GradReducer(None, "bucketed", ring=comm.LoopbackRing(1))
    state = create_train_state(model, tx, ddp=False)
    step = make_train_step(model, tx, reduce=reducer)
    step(state, {"image": torch.randn(2, 3, 5, 5),
                 "label": torch.tensor([0, 3])})
    assert seen["conv.weight"][0] == seen["conv.weight"][1] != (27, 9, 3, 1)
