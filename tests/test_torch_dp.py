"""Data parallelism of the port on the CPU: two gloo ranks, each running
``tpudist_torch.train.fit`` on its half of every batch, end where one
process running ``fit`` on the concatenated batches ends: the same
per-step losses (the global-batch mean), parameters and BN running
statistics. This holds the cross-replica BatchNorm (global statistics
through an autograd-aware all-reduce) and DDP's gradient averaging to
the reference's global-batch semantics.

Tolerances: losses within 1e-5 relative; parameters and statistics
within 1e-4 relative plus 1e-4 absolute (a tenth of ``lr``, as in
tests/test_torch_train.py): the two-rank run sums the gradients and the
BN statistics in another order than the one-process run. In float32
that order is all that keeps the runs apart, and it grows: flax's
``E[x^2] - E[x]^2`` statistics cancel, so the gradients carry errors of
a few percent, which Adam's normalised steps carry on (after 6 steps the
two float32 runs' losses differ by 2e-3 relative). The float64 case trains twice
as long and holds the losses to 1e-6: the semantics are the same, only
float32 rounding differs."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
STEPS, HALF = 3, 4

WORKER = """
import sys
import torch
from tpudist_torch.data.cifar import synthetic_cifar, to_tensor
from tpudist_torch.data.loader import DataLoader
from tpudist_torch.data.sampler import DistributedSampler
from tpudist_torch.distributed import barrier, init_from_env, reduce_loss
from tpudist_torch.models.resnet import resnet18
from tpudist_torch.optim import make_optimizer
from tpudist_torch.train import fit

out, fused, steps, half = sys.argv[1], sys.argv[2] == "optimizer", int(sys.argv[3]), int(sys.argv[4])
dtype = getattr(torch, sys.argv[5])
ctx = init_from_env("cpu")
data = synthetic_cifar(steps * half * 2, num_classes=100, seed=5)
# unshuffled: rank r's batch k is rows 2*half*k + r + 2j, the 1-rank run's
# batch k is rows 2*half*k .. 2*half*(k+1) - 1: the same rows
sampler = DistributedSampler(len(data["label"]), num_replicas=ctx.world_size,
                             rank=ctx.rank, shuffle=False)
loader = DataLoader(data, half * 2 // ctx.world_size, sampler=sampler,
                    transform=to_tensor)
model = resnet18(num_filters=8, device="cpu", seed=0, dtype=dtype).to(dtype)
state, losses = fit(model, make_optimizer(1e-3, fused=fused), loader, epochs=1,
                    fused="optimizer" if fused else None, profile=False,
                    log_dir=out + "_logs")
barrier()
torch.save({"losses": losses, "params": state.params(),
            "stats": state.batch_stats(),
            "mean_rank": reduce_loss(float(ctx.rank))}, out)
if ctx.world_size > 1:
    torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, world, fused, steps=STEPS, dtype="float32"):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "2"}
        out = tmp_path / f"w{world}_r{rank}.pt"
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", WORKER, str(out), str(fused), str(steps),
             str(HALF), dtype], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    results = []
    try:
        for out, proc in procs:
            log, _ = proc.communicate(timeout=120)
            assert proc.returncode == 0, log
            results.append(torch.load(out))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
    return results


@pytest.mark.parametrize("fused", ["none", "optimizer"])
def test_two_gloo_ranks_equal_one_rank(tmp_path, fused):
    two = _launch(tmp_path, 2, fused)
    (one,) = _launch(tmp_path, 1, fused)
    assert len(one["losses"]) == STEPS
    for r in two:  # every rank reports the global-batch mean loss
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        assert r["mean_rank"] == 0.5  # reduce_loss: the mean over ranks
    assert one["mean_rank"] == 0.0
    for key in ("params", "stats"):
        assert two[0][key].keys() == one[key].keys()
        for k, want in one[key].items():
            for r in two:
                np.testing.assert_allclose(
                    r[key][k].numpy(), want.numpy(), rtol=1e-4, atol=1e-4,
                    err_msg=f"{key} {k}")


def test_two_gloo_ranks_equal_one_rank_in_float64(tmp_path):
    two = _launch(tmp_path, 2, "optimizer", steps=2 * STEPS, dtype="float64")
    (one,) = _launch(tmp_path, 1, "optimizer", steps=2 * STEPS,
                     dtype="float64")
    assert len(one["losses"]) == 2 * STEPS
    for r in two:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-6)
        for key in ("params", "stats"):
            for k, want in one[key].items():
                np.testing.assert_allclose(
                    r[key][k].numpy(), want.numpy(), rtol=1e-6, atol=1e-6,
                    err_msg=f"{key} {k}")
