"""The pipeline schedule (``tpudist_torch.parallel.pp.pipeline_apply``)
against the JAX package's ``pipeline_apply`` and the sequential stack, in
one gloo world of 4 ranks.

- The reference's residual MLP block (``tests/test_pipeline.py``'s
  ``_mlp_block``: ``h + gelu(h @ w1) @ w2``, tanh GELU), 8 layers, width
  16, hidden 32, weights made with numpy from a seed at half the
  reference's ``1 / sqrt(d)`` scale (the residual stream stays near unit
  size, so f32 rounding stays near 1e-7), a batch of 16 rows of 4
  positions in 4 microbatches; over 2 pipe ranks (beside 2 data
  replicas, each its half of the rows) and over 4.
- The outputs on every pipe rank, and the gradients of a squared error
  with respect to the blocks and the input, under GPipe and 1F1B: against
  the reference's GPipe schedule on a ``MeshConfig(data=8 // n, pipe=n)``
  mesh of CPU devices and against the sequential stack, within f32
  ``rtol = atol = 1e-6``. The reference's 1F1B does not run on this jax
  (ROADMAP Queue 3), so the port's 1F1B is held to the same two.
- The reference's three errors, in its words.
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

from tpudist import mesh as jax_mesh
from tpudist.parallel.pp import pipeline_apply as jax_pipeline_apply
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
LAYERS, D, HIDDEN, B, POS, MICRO = 8, 16, 32, 16, 4, 4
#: f32: the port's schedule against the reference's and the stack
TOL = 1e-6

WORKER = r"""
import os, sys
import torch
import torch.distributed as dist
import torch.nn.functional as F
from tpudist_torch.distributed import init_from_env
from tpudist_torch.mesh import MeshConfig, create_layout
from tpudist_torch.parallel import pp

torch.set_num_threads(1)
src, out = sys.argv[1], sys.argv[2]
ctx = init_from_env("cpu")
data = torch.load(src)
w1, w2, x, y = data["w1"], data["w2"], data["x"], data["y"]
res = {}


def block(h, a, b):
    return h + F.gelu(h @ a, approximate="tanh") @ b


for n in (2, 4):
    lay = create_layout(MeshConfig(data=-1, pipe=n))
    res[("worlds", n, ctx.rank)] = (lay.data, lay.pipe, lay.pipe_idx,
                                    lay.pipe_ranks)
    held = pp.stage_layers(w1.shape[0], n, lay.pipe_idx)
    rows = x.chunk(lay.data)[lay.data_idx]
    target = y.chunk(lay.data)[lay.data_idx]
    for schedule in pp.SCHEDULES:
        a = w1[held.start:held.stop].clone().requires_grad_(True)
        b = w2[held.start:held.stop].clone().requires_grad_(True)
        xr = rows.clone().requires_grad_(True)

        def stage(h):
            for i in range(a.shape[0]):
                h = block(h, a[i], b[i])
            return h

        got = pp.pipeline_apply(stage, xr, lay, num_micro=data["micro"],
                                schedule=schedule, params=[a, b])
        # the mean over the whole batch: this replica's share of it
        loss = ((got - target) ** 2).sum() / y.numel()
        loss.backward()
        ga, gb, gx = a.grad.clone(), b.grad.clone(), xr.grad.clone()
        if lay.data > 1:
            dist.all_reduce(ga, group=lay.data_group)
            dist.all_reduce(gb, group=lay.data_group)
        res[(n, schedule, ctx.rank)] = {
            "out": got.detach(), "w1": ga, "w2": gb, "x": gx,
            "layers": (held.start, held.stop), "replica": lay.data_idx}

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


def _mlp_block(p, h):
    return h + jax.nn.gelu(h @ p["w1"]) @ p["w2"]


def _sequential(params, x):
    def layer(h, p):
        return _mlp_block(p, h), None

    out, _ = jax.lax.scan(layer, x, params)
    return out


def _loss(apply, params, x, y):
    return jnp.mean((apply(params, x) - y) ** 2)


def _reference(params, x, y, n):
    """The reference's GPipe on a data x pipe mesh of 8 CPU devices:
    outputs and the gradients of the mean squared error."""
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(data=8 // n, pipe=n))

    def apply(p, xs):
        return jax_pipeline_apply(_mlp_block, p, xs, mesh, num_micro=MICRO)

    out = jax.jit(apply)(params, x)
    grads = jax.jit(jax.grad(lambda p, xs: _loss(apply, p, xs, y),
                             argnums=(0, 1)))(params, x)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    rng = np.random.Generator(np.random.PCG64(11))
    scale = 0.5 / np.sqrt(D)
    w1 = (rng.standard_normal((LAYERS, D, HIDDEN)) * scale).astype(np.float32)
    w2 = (rng.standard_normal((LAYERS, HIDDEN, D)) * scale).astype(np.float32)
    x = rng.standard_normal((B, POS, D)).astype(np.float32)
    y = rng.standard_normal((B, POS, D)).astype(np.float32)
    params = {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}
    seq_out = np.asarray(_sequential(params, jnp.asarray(x)))
    seq_grads = jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p, xs: _loss(_sequential, p, xs, jnp.asarray(y)),
        argnums=(0, 1))(params, jnp.asarray(x)))
    refs = {n: _reference(params, jnp.asarray(x), jnp.asarray(y), n)
            for n in (2, 4)}
    got = _spawn(tmp, {"w1": torch.from_numpy(w1), "w2": torch.from_numpy(w2),
                       "x": torch.from_numpy(x), "y": torch.from_numpy(y),
                       "micro": MICRO})
    return got, refs, (seq_out, seq_grads)


def _assemble(got, n, schedule):
    """The whole output and gradients from the ranks' parts: each
    replica's rows, each stage's layers."""
    out = np.zeros((B, POS, D), np.float32)
    w1 = np.zeros((LAYERS, D, HIDDEN), np.float32)
    w2 = np.zeros((LAYERS, HIDDEN, D), np.float32)
    dx = np.zeros((B, POS, D), np.float32)
    replicas = 4 // n
    rows = B // replicas
    for rank in range(4):
        r = got[(n, schedule, rank)]
        lo, hi = r["layers"]
        sl = slice(r["replica"] * rows, (r["replica"] + 1) * rows)
        out[sl] = r["out"].numpy()
        dx[sl] = r["x"].numpy()
        w1[lo:hi] = r["w1"].numpy()
        w2[lo:hi] = r["w2"].numpy()
    return out, {"w1": w1, "w2": w2}, dx


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("n", [2, 4], ids=["pipe2", "pipe4"])
def test_pipeline_matches_the_reference_and_the_stack(world, n, schedule):
    got, refs, (seq_out, (seq_p, seq_x)) = world
    ref_out, (ref_p, ref_x) = refs[n]
    out, grads, dx = _assemble(got, n, schedule)
    for want in (ref_out, seq_out):
        np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
    for want_p, want_x in ((ref_p, ref_x), (seq_p, seq_x)):
        for k in ("w1", "w2"):
            np.testing.assert_allclose(grads[k], want_p[k], rtol=TOL,
                                       atol=TOL, err_msg=k)
        np.testing.assert_allclose(dx, want_x, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [2, 4], ids=["pipe2", "pipe4"])
def test_every_stage_holds_the_output_and_the_input_cotangent(world, n):
    """The last stage's outputs reach every pipe rank, and stage 0's input
    cotangents too (the reference's two ``psum`` s), bit for bit; 1F1B's
    forward is GPipe's."""
    got, _, _ = world
    for rank in range(4):
        data, pipe, idx, ranks = got[("worlds", n, rank)]
        assert (data, pipe) == (4 // n, n) and ranks[idx] == rank
        first = got[(n, "gpipe", ranks[0])]
        for schedule in ("gpipe", "1f1b"):
            r = got[(n, schedule, rank)]
            assert torch.equal(r["out"], first["out"])
            assert torch.equal(r["x"], got[(n, schedule, ranks[0])]["x"])


@pytest.mark.parametrize("call,match", [
    ("schedule", r"schedule must be one of \('gpipe', '1f1b'\), got '2f2b'"),
    ("layers", "6 layers not divisible by 4 stages"),
    ("batch", "batch 6 not divisible by num_micro 4"),
], ids=["schedule", "layers", "batch"])
def test_the_references_errors(call, match):
    from tpudist_torch.mesh import RankLayout
    from tpudist_torch.parallel import pp

    lay = RankLayout(0, 1, 1, pipe=2)
    x = torch.zeros(8, 2)
    with pytest.raises(ValueError, match=match):
        if call == "schedule":
            pp.pipeline_apply(lambda h: h, x, lay, num_micro=4,
                              schedule="2f2b")
        elif call == "layers":
            pp.stage_layers(6, 4, 0)
        else:
            pp.pipeline_apply(lambda h: h, x[:6], lay, num_micro=4)
    # the reference's own words
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(data=2, pipe=4))
    stacked = {"w": jnp.zeros((6 if call == "layers" else 8, 2, 2))}
    xs = jnp.zeros((6 if call == "batch" else 8, 2))
    with pytest.raises(ValueError, match=match):
        jax_pipeline_apply(lambda p, h: h, stacked, xs, mesh, num_micro=4,
                           schedule="2f2b" if call == "schedule" else "gpipe")


def test_rank_coordinates_are_the_references_device_order():
    """``data x pipe x tensor`` over 8 ranks: rank r sits where the
    reference's mesh (axis order data, fsdp, pipe, expert, seq, tensor)
    puts device r; a stage's ranks, its neighbours and its batch peers."""
    from tpudist_torch.mesh import MeshConfig, RankLayout

    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(data=2, pipe=2,
                                                    tensor=2),
                                devices=jax.devices()[:8])
    grid = np.vectorize(lambda d: d.id)(np.asarray(mesh.devices)).reshape(
        2, 2, 2)
    assert MeshConfig(data=-1, pipe=2, tensor=2).axis_sizes(8) == {
        "data": 2, "fsdp": 1, "pipe": 2, "expert": 1, "seq": 1, "tensor": 2}
    for rank in range(8):
        ranks = tuple(int(r) for r in grid[rank // 4, :, rank % 2])
        lay = RankLayout(rank, 2, 1, tensor=2, pipe=2, pipe_ranks=ranks)
        assert grid[lay.data_idx, lay.pipe_idx, lay.tensor_idx] == rank
        assert lay.replica == lay.data_idx
        assert lay.prev_stage == (None if lay.pipe_idx == 0 else ranks[0])
        assert lay.next_stage == (None if lay.pipe_idx == 1 else ranks[1])
    with pytest.raises(NotImplementedError, match=r"#7c \(remainder\)"):
        MeshConfig(pipe=2, seq=2).axis_sizes(4)


def test_one_stage_runs_the_stage_on_the_whole_batch():
    from tpudist_torch.parallel import pp

    x = torch.arange(8.0).reshape(8, 1)
    assert torch.equal(pp.pipeline_apply(lambda h: 2 * h, x, None,
                                         num_micro=4), 2 * x)
    names = ["wte", "h.0.qkv.weight", "h.3.out.bias", "ln_f.scale"]
    assert pp.stage_names(names, 4, 2, 1) == ["wte", "h.3.out.bias",
                                             "ln_f.scale"]
    assert pp.stage_local_names(names) == ["h.0.qkv.weight", "h.3.out.bias"]
