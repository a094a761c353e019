"""The port's rotating device cache (tpudist_torch.data.device_cache.
RotatingDeviceCache) against the reference's on the CPU: the index and
label batches equal ``tpudist``'s for several (rows, shard rows, world,
rank, epoch), a ragged tail included; the pixels the step gathers from
each shard equal a host gather of the same rows; every row once an epoch;
``iter_from``; the guards; ``fit`` over the rotation trains, and a run
preempted mid-epoch resumes bit-identical to one that was not; a staging
failure is raised in the training loop."""

import jax
import numpy as np
import pytest
import torch

from tpudist import mesh as mesh_lib
from tpudist.data.device_cache import RotatingDeviceCache as JaxRotation
from tpudist_torch.data.cifar import synthetic_cifar
from tpudist_torch.data.device_cache import RotatingDeviceCache
from tpudist_torch.data.loader import prefetch_to_device
from tpudist_torch.models.resnet import resnet18
from tpudist_torch.optim import make_optimizer
from tpudist_torch.resilience import GENERATION_ENV, Preempted
from tpudist_torch.train import fit


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _data(n, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return {"image": rng.integers(0, 256, (n, 4, 4, 3)).astype(np.uint8),
            "label": np.arange(n, dtype=np.int32)}


@pytest.mark.parametrize("n,shard_rows,batch,world,rank,epoch", [
    (64, 16, 8, 1, 0, 0), (64, 16, 4, 2, 1, 1), (70, 16, 4, 2, 0, 2),
    (100, 24, 4, 3, 2, 5), (40, 64, 8, 1, 0, 3),
], ids=lambda v: str(v))
def test_batches_equal_the_references(n, shard_rows, batch, world, rank,
                                      epoch):
    data = _data(n)
    kw = dict(shard_rows=shard_rows, seed=3, rank=rank, num_replicas=world)
    mine = RotatingDeviceCache(data, batch, device="cpu", **kw)
    ref = JaxRotation(data, batch, mesh=mesh_lib.create_mesh(
        devices=jax.devices()[:1]), **kw)
    mine.set_epoch(epoch)
    ref.set_epoch(epoch)
    assert len(mine) == len(ref) > 0
    gather = mine.input_transform()
    for start in (0, len(mine) - 1):
        got, want = list(mine.iter_from(start)), list(ref.iter_from(start))
        assert len(got) == len(want) == len(mine) - start
        for g, w in zip(got, want):
            for k in ("image", "label"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(np.asarray(w["_cache"]),
                                          g["_cache"].numpy())
            # the step's gather: the rows the labels name, bit for bit
            images = gather(torch.from_numpy(g["image"]), g)
            np.testing.assert_array_equal(images.numpy(),
                                          data["image"][g["label"]])
    assert mine.stage_log and all(e["rows"] == mine.shard_rows
                                  for e in mine.stage_log)


def test_every_row_once_an_epoch_and_rank_strides_disjoint():
    data = _data(48)
    ranks = [RotatingDeviceCache(data, 4, shard_rows=16, device="cpu",
                                 rank=r, num_replicas=2) for r in range(2)]
    seen = {}
    for epoch in (0, 1):
        rows = []
        for rot in ranks:
            rot.set_epoch(epoch)
            rows.append([int(x) for b in rot for x in b["label"]])
        assert not set(rows[0]) & set(rows[1])
        assert sorted(rows[0] + rows[1]) == list(range(48))
        seen[epoch] = rows[0]
    assert seen[0] != seen[1]  # the plan is keyed by the epoch


def test_guards_and_the_probe(caplog):
    data = _data(40)
    with pytest.raises(ValueError, match="must divide by the global batch"):
        RotatingDeviceCache(data, 6, shard_rows=16, device="cpu")
    with pytest.raises(ValueError, match="C-contiguous"):
        RotatingDeviceCache({"image": data["image"][:, ::-1],
                             "label": data["label"]}, 4, shard_rows=8,
                            device="cpu")
    with caplog.at_level("WARNING"):
        rot = RotatingDeviceCache(data, 4, shard_rows=16, device="cpu")
    assert "ragged tail shard is dropped" in caplog.text
    assert len(rot) == 2 * 4 and rot.sampler is rot
    probe = rot.probe()
    assert probe["image"].shape == (1, 4, 4, 3)
    assert probe["image"].dtype == np.float32
    staged = list(prefetch_to_device(iter(rot), "cpu"))
    assert len(staged) == 8 and staged[0]["_ready"] is None


def _run(tmp_path, ckpt, chaos):
    data = synthetic_cifar(48, num_classes=10, seed=4)
    model = resnet18(num_filters=8, num_classes=10, small_inputs=True,
                     device="cpu")
    rot = RotatingDeviceCache(data, 8, shard_rows=16, device="cpu", seed=2)
    post = rot.input_transform(lambda x: x.float() / torch.full((), 255.0))
    return fit(model, make_optimizer(1e-3), rot, epochs=2,
               input_transform=post, profile=False, log_dir=str(tmp_path),
               checkpoint_dir=str(ckpt), checkpoint_every=4, chaos=chaos)


def test_fit_trains_and_resumes_mid_epoch_bit_identical(tmp_path,
                                                        monkeypatch):
    """6 steps an epoch (3 shards of 2 batches); preempted at step 9, in
    epoch 1's second shard, the next life resumes there."""
    monkeypatch.delenv(GENERATION_ENV, raising=False)
    state, full = _run(tmp_path, tmp_path / "full", None)
    assert len(full) == 12 and np.isfinite(full).all()
    assert np.mean(full[-3:]) < np.mean(full[:3])
    with pytest.raises(Preempted) as ei:
        _run(tmp_path, tmp_path / "cut", "sigterm@9")
    assert ei.value.step == 9 and ei.value.losses == full[:9]
    monkeypatch.setenv(GENERATION_ENV, "1")
    resumed, rest = _run(tmp_path, tmp_path / "cut", "sigterm@9")
    assert resumed.step == 12 and rest == full[9:]
    for k, v in state.params().items():
        assert torch.equal(v, resumed.params()[k]), k


def test_a_staging_failure_is_raised_in_the_training_loop(tmp_path):
    data = synthetic_cifar(48, num_classes=10, seed=4)
    rot = RotatingDeviceCache(data, 8, shard_rows=16, device="cpu")
    stage = rot._stage
    calls = []

    def failing(rows):
        calls.append(len(rows))
        if len(calls) == 2:
            raise OSError("pack read failed")
        return stage(rows)

    rot._stage = failing
    model = resnet18(num_filters=8, num_classes=10, small_inputs=True,
                     device="cpu")
    post = rot.input_transform(lambda x: x.float() / 255.0)
    with pytest.raises(OSError, match="pack read failed"):
        fit(model, make_optimizer(1e-3), rot, epochs=1, input_transform=post,
            profile=False, log_dir=str(tmp_path))
    assert calls == [16, 16]
