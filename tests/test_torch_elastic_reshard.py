"""The elastic reshard (``tpudist_torch.resilience.elastic``,
``fit(elastic=True)``) against ``tpudist.resilience.elastic``.

- ZeRO-1's relayout (the flat prefix copied, the tail re-padded) of saved
  arrays 4 -> 2 and 2 -> 4 equals the reference's ``_relayout`` on the
  same arrays, for pad leaves, shard leaves and the leaves whose
  classification changes with the world.
- ``remap_step`` equals the reference's; a changed ``reduce`` (or
  ``shard_opt_state``) refuses with ``ElasticRefusal``.
- ``fit(elastic=True)`` over gloo, a mini version of the reference's
  ``test_elastic.py`` drill: a 4-rank ZeRO-1 + quantized run checkpoints
  the end of its first epoch; a 2-rank run resumes it (the pad and
  classification-change leaves relaid, the residual flushed, the meta
  committed) and trains the second epoch. Its first loss comes from the
  restored parameters: within 1e-5 of the uninterrupted 4-rank run's at
  that step (the reference's pin); the epoch tracks the uninterrupted
  4-rank and 2-rank runs within the reference's 0.08 relative. The same
  drill with the deterministic ``bucketed`` reducer is held to the
  reference's ``fit(elastic=True)`` on 4 then 2 CPU devices, from the
  same weights over the same rows, at the bucketed bars. Without
  ``elastic`` the resize refuses, naming the flag. The restored optimizer
  state is bit-identical, leaf by logical leaf, to the saved one.
- The checkpointer's quarantine rolls back an interrupted reshard, and
  adopts the marker's meta when the new-world save landed.
"""

import json
import math
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
from jax.sharding import NamedSharding, PartitionSpec as P

from tpudist import optim as jax_optim
from tpudist.resilience import elastic as jax_elastic
from tpudist_torch import optim
from tpudist_torch.checkpoint import Checkpointer
from tpudist_torch.resilience import elastic
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _stored(logical: np.ndarray, world: int) -> np.ndarray:
    """A leaf as ZeRO-1 stores it globally at ``world``."""
    mode, cols = optim._zero1_layout(logical.shape, world, 1024)
    if mode != "pad":
        return logical
    flat = np.zeros(world * cols, logical.dtype)
    flat[:logical.size] = logical.ravel()
    return flat.reshape(world, cols)


SHAPES = [(41, 37), (82, 37), (41, 82), (64, 41), (4096,), (37, 41, 3)]


@pytest.mark.parametrize("old,new", [(4, 2), (2, 4)])
def test_relayout_equals_the_references(old, new):
    rng = np.random.default_rng(old)
    sharding = NamedSharding(jax.sharding.Mesh(np.asarray(jax.devices()[:1]),
                                               ("data",)), P())
    moved = 0
    for shape in SHAPES:
        logical = rng.normal(size=shape).astype(np.float32)
        saved = _stored(logical, old)
        target = _stored(logical, new).shape
        ours = elastic.relayout(torch.from_numpy(saved), target).numpy()
        ref = np.asarray(jax_elastic._relayout(jax.numpy.asarray(saved),
                                               target, sharding))
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(ours, _stored(logical, new))
        moved += saved.shape != target
        assert optim._zero1_layout(shape, old, 1024) == \
            jax_optim._zero1_layout(shape, old, 1024)
    assert moved >= 3


def _meta(world, spe=4, **over):
    m = {"steps_per_epoch": spe, "batch_size": 16, "world_size": world,
         "grad_accum": 1, "fsdp_world": 1, "tensor_world": 1,
         "pipe_world": 1, "shard_opt_state": True, "reduce": "quantized",
         "data_world": world}
    m.update(over)
    return m


@pytest.mark.parametrize("step,old,new", [
    (6, 4, 4), (6, 4, 8), (6, 8, 4), (5, 8, 4), (7, None, 4), (0, 4, 8),
    (13, 3, 7)])
def test_remap_step_equals_the_references(step, old, new):
    saved, run = {"steps_per_epoch": old}, {"steps_per_epoch": new}
    assert elastic.remap_step(step, saved, run) == jax_elastic.remap_step(
        step, saved, run)


def test_semantic_changes_refuse():
    assert elastic.elastic_mismatch(_meta(4), _meta(2, spe=8))
    for over in ({"reduce": "bucketed"}, {"shard_opt_state": False},
                 {"fsdp_world": 2}):
        reason = elastic.refusal_reason(_meta(4), _meta(2, **over))
        assert reason == jax_elastic.refusal_reason(_meta(4),
                                                    _meta(2, **over))

    class Ck:
        directory = "ck"

    with pytest.raises(elastic.ElasticRefusal, match="reduce"):
        elastic.reshard_restore(Ck(), None, 4, saved_meta=_meta(4),
                                run_meta=_meta(2, reduce="bucketed"))


WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from tpudist_torch.data.loader import DataLoader
from tpudist_torch.data.sampler import DistributedSampler
from tpudist_torch.distributed import init_from_env
from tpudist_torch.optim import make_optimizer
from tpudist_torch.train import fit

torch.set_num_threads(1)
out, ck, epochs, elastic = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    sys.argv[4] == "1"
# the reducer, and a file of starting weights (else the Net's own)
reduce = sys.argv[5] if len(sys.argv) > 5 else "quantized"
weights = sys.argv[6] if len(sys.argv) > 6 else None
ctx = init_from_env("cpu")
r, w = ctx.rank, ctx.world_size


class Net(nn.Module):
    # ZeRO-1 at 2 / 4: fc0.weight [82, 37] shard / pad (classification
    # change), fc1.weight [41, 82] shard / pad, fc2.weight [37, 41] pad at
    # both, the rest replicated
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.fc0, self.fc1 = nn.Linear(37, 82), nn.Linear(82, 41)
        self.fc2, self.head = nn.Linear(41, 37), nn.Linear(37, 10)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.2)

    def forward(self, x):
        h = torch.tanh(self.fc1(torch.tanh(self.fc0(x))))
        return self.head(torch.tanh(self.fc2(h)))


rng = np.random.default_rng(0)
data = {"image": rng.normal(size=(64, 37)).astype(np.float32),
        "label": (rng.random(64) * 10).astype(np.int32)}
# the reference's drill: 64 rows, a global batch of 16, Adam 1e-2
sampler = DistributedSampler(64, num_replicas=w, rank=r, shuffle=False)
loader = DataLoader(data, 16 // w, sampler=sampler)
kw = dict(checkpoint_dir=ck) if ck != "-" else {}
net = Net()
if weights is not None:
    net.load_state_dict(torch.load(weights))
try:
    state, losses = fit(net, make_optimizer(1e-2), loader, epochs=epochs,
                        profile=False, log_dir=out + "_logs",
                        shard_opt_state=True, reduce=reduce,
                        elastic=elastic, **kw)
except ValueError as exc:
    if r == 0:
        torch.save({"refused": str(exc)}, out)
    sys.exit(0)
logical = {}
z = state.opt_state
for k, p in z.params.items():
    for part in ("mu", "nu"):
        t = getattr(z.inner, part)[k]
        mode, info = z.modes[k]
        if mode != "replicate":
            parts = [torch.empty_like(t) for _ in range(w)]
            dist.all_gather(parts, t.contiguous())
            t = torch.cat(parts, info) if mode == "shard" else \
                torch.cat([q.reshape(-1) for q in parts])[:p.numel()].view(
                    p.shape)
        logical[f"{part}.{k}"] = t.clone()
params = state.params()
if r == 0:
    torch.save({"losses": losses, "step": state.step, "opt": logical,
                "params": params,
                "residual": None if state.comm_residual is None
                else state.comm_residual.clone()}, out)
dist.destroy_process_group()
"""


def _free_port() -> int:
    from torch_ports import free_port

    return free_port()


def _world(tmp, tag, world, ck, epochs, elastic_flag, *extra):
    return _results(tmp, tag, _launch(tmp, tag, world, ck, epochs,
                                      elastic_flag, *extra))


def _launch(tmp, tag, world, ck, epochs, elastic_flag, *extra):
    script = tmp / "worker.py"
    script.write_text(WORKER)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR":
               "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp / tag), str(ck),
             str(epochs), "1" if elastic_flag else "0", *extra], env=env,
            cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def _results(tmp, tag, procs):
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-4000:]
        logs.append(out.decode())
    return torch.load(tmp / tag, weights_only=False), logs[0]


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    ck = tmp / "ck"
    first, _ = _world(tmp, "w4_epoch0", 4, ck, 1, False)
    refused, _ = _world(tmp, "w2_refused", 2, ck, 2, False)
    resumed, log = _world(tmp, "w2_resumed", 2, ck, 2, True)
    ref4, _ = _world(tmp, "ref4", 4, "-", 2, False)
    ref2, _ = _world(tmp, "ref2", 2, "-", 2, False)
    meta = json.loads((ck / "tpudist_meta.json").read_text())
    steps = sorted(int(d.name) for d in ck.iterdir() if d.name.isdigit())
    return dict(first=first, refused=refused, resumed=resumed, log=log,
                ref4=ref4, ref2=ref2, meta=meta, steps=steps,
                quarantine=(ck / "_pre_reshard").exists())


def test_resize_without_elastic_refuses(drill):
    assert "elastic=True" in drill["refused"]["refused"]


def test_elastic_resume_continues_the_trajectory(drill):
    spe = 4
    losses = drill["resumed"]["losses"]
    assert len(losses) == spe and drill["resumed"]["step"] == 2 * spe
    ref4, ref2 = drill["ref4"]["losses"], drill["ref2"]["losses"]
    np.testing.assert_allclose(drill["first"]["losses"], ref4[:spe],
                               rtol=0)
    assert losses[0] == pytest.approx(ref4[spe], rel=1e-5)
    np.testing.assert_allclose(losses, ref4[spe:], rtol=0.08)
    np.testing.assert_allclose(losses, ref2[spe:], rtol=0.08)
    assert "reshard: " in drill["log"]
    ev = json.loads(drill["log"].split("reshard: ")[1].splitlines()[0])
    assert (ev["old_world"], ev["new_world"]) == (4, 2)
    assert ev["residual_flushed"] and ev["cursor_exact"]
    assert ev["resharded_leaves"] >= 4


def test_commit_replaced_the_old_world_steps(drill):
    assert drill["meta"]["data_world"] == 2
    assert min(drill["steps"]) >= 4 and max(drill["steps"]) == 8
    assert not drill["quarantine"]


class _JaxNet(fnn.Module):
    """The worker's Net in flax: Dense_0..3 are fc0, fc1, fc2 and head."""

    @fnn.compact
    def __call__(self, x, train=False):
        h = jnp.tanh(fnn.Dense(82)(x))
        h = jnp.tanh(fnn.Dense(41)(h))
        h = jnp.tanh(fnn.Dense(37)(h))
        return fnn.Dense(10)(h)


def test_bucketed_elastic_resume_matches_the_references(
        tmp_path, no_persistent_compile_cache):
    """The deterministic drill against the reference's own: ZeRO-1 with
    the ``bucketed`` reducer, one epoch on 4 ranks (4 CPU devices for the
    reference), then ``fit(elastic=True)`` on 2 for the second, from the
    same weights over the same rows. The losses of both epochs are held
    to ``test_torch_dp_reduce.py``'s bucketed bar (1e-5 relative) and the
    final parameters to ``test_torch_gpt2_train.py``'s (1e-4 relative
    plus 1e-4 absolute)."""
    from tpudist.data.loader import DataLoader as JaxLoader
    from tpudist.mesh import create_mesh
    from tpudist.train import fit as jax_fit

    rng = np.random.default_rng(5)
    widths = [(37, 82), (82, 41), (41, 37), (37, 10)]
    flax_params = {f"Dense_{i}": {
        "kernel": (rng.normal(size=(i_, o)) * 0.2).astype(np.float32),
        "bias": (rng.normal(size=(o,)) * 0.2).astype(np.float32)}
        for i, (i_, o) in enumerate(widths)}
    names = ["fc0", "fc1", "fc2", "head"]
    torch.save({f"{n}.{part}": torch.from_numpy(
        flax_params[f"Dense_{i}"][leaf].T.copy() if part == "weight" else
        flax_params[f"Dense_{i}"][leaf].copy())
        for i, n in enumerate(names)
        for part, leaf in (("weight", "kernel"), ("bias", "bias"))},
        tmp_path / "w.pt")
    data_rng = np.random.default_rng(0)
    data = {"image": data_rng.normal(size=(64, 37)).astype(np.float32),
            "label": (data_rng.random(64) * 10).astype(np.int32)}
    want, ck, weights = [], tmp_path / "ck", str(tmp_path / "w.pt")
    got = []
    for world, epochs in ((4, 1), (2, 2)):
        # the port's world trains while the reference does
        tag = f"b{world}"
        procs = _launch(tmp_path, tag, world, ck, epochs, world == 2,
                        "bucketed", weights)
        state, losses = jax_fit(
            _JaxNet(), optax.adam(1e-2), JaxLoader(data, 16), epochs=epochs,
            mesh=create_mesh(devices=jax.devices()[:world]), batch_size=16,
            job_id=f"J{world}", log_dir=str(tmp_path), profile=False,
            reduce="bucketed", shard_opt_state=True,
            checkpoint_dir=str(tmp_path / "jck"), elastic=world == 2,
            init_params=flax_params)
        want.append(losses)
        got.append(_results(tmp_path, tag, procs))
    final = jax.tree_util.tree_map(np.asarray, state.params)
    (first, _), (resumed, log) = got
    assert [len(x) for x in want] == [4, 4]
    np.testing.assert_allclose(first["losses"], want[0], rtol=1e-5)
    np.testing.assert_allclose(resumed["losses"], want[1], rtol=1e-5)
    ev = json.loads(log.split("reshard: ")[1].splitlines()[0])
    assert (ev["old_world"], ev["new_world"]) == (4, 2)
    for i, n in enumerate(names):
        for part, leaf in (("weight", "kernel"), ("bias", "bias")):
            w = final[f"Dense_{i}"][leaf]
            np.testing.assert_allclose(
                resumed["params"][f"{n}.{part}"].numpy(),
                w.T if part == "weight" else w, rtol=1e-4, atol=1e-4,
                err_msg=f"{n}.{part}")


def test_restored_optimizer_state_is_the_saved_one(tmp_path):
    """The 4 -> 2 and 2 -> 4 restores alone: the logical optimizer
    leaves after the reshard are bit-identical to those saved, the
    residual comes back zero at the new world's layout."""
    pairs = ((4, 2), (2, 4))
    # the two drills' worlds run side by side
    saves = {(o, n): _launch(tmp_path, f"a{o}", o, tmp_path / f"ck{o}{n}", 1,
                             False) for o, n in pairs}
    saves = {k: _results(tmp_path, f"a{k[0]}", v)[0] for k, v in saves.items()}
    backs = {(o, n): _launch(tmp_path, f"b{n}", n, tmp_path / f"ck{o}{n}", 1,
                             True) for o, n in pairs}
    backs = {k: _results(tmp_path, f"b{k[1]}", v)[0] for k, v in backs.items()}
    for old, new in pairs:
        saved, back = saves[(old, new)], backs[(old, new)]
        assert saved["residual"].abs().sum() > 0
        # epochs=1 is complete: the resumed run trains nothing more
        assert back["losses"] == [] and back["step"] == saved["step"]
        assert back["opt"].keys() == saved["opt"].keys()
        for k, t in saved["opt"].items():
            assert torch.equal(back["opt"][k], t), (old, new, k)
        for k, t in saved["params"].items():
            assert torch.equal(back["params"][k], t), k
        assert not back["residual"].any()


def test_quarantine_rolls_back_an_interrupted_reshard(tmp_path):
    from tpudist_torch.models.resnet import resnet18
    from tpudist_torch.train import create_train_state

    state = create_train_state(resnet18(num_filters=8, device="cpu"),
                               optim.make_optimizer(1e-3))
    state.step = 4
    ck = Checkpointer(tmp_path / "ck")
    ck.write_meta(_meta(4))
    ck.save(state, wait=True)
    assert ck.quarantine_steps(commit_meta=_meta(2)) == [4]
    assert ck.latest_step() is None          # ... the process dies here
    ck.close()
    ck = Checkpointer(tmp_path / "ck")
    assert ck.recover_interrupted_reshard() == "rolled_back"
    assert ck.latest_step() == 4 and ck.read_meta() == _meta(4)
    assert ck.recover_interrupted_reshard() is None
    # the other window: the new-world save landed, the meta flip did not
    ck.quarantine_steps(commit_meta=_meta(2))
    state.step = 8
    ck.save(state, wait=True)
    ck.close()
    ck = Checkpointer(tmp_path / "ck")
    assert ck.recover_interrupted_reshard() == "completed"
    assert ck.read_meta() == _meta(2) and ck.all_steps() == [8]
    assert not (tmp_path / "ck" / "_pre_reshard").exists()
    ck.close()
