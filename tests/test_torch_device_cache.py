"""The port's device-cached loader (tpudist_torch.data.device_cache) and
``main.py --device_cache`` / ``--augment`` against the JAX reference.

The loader's index batches, labels, length and ``iter_from`` equal the
reference ``DeviceCachedLoader``'s on the same sampler, and its gather
returns the reference's images. Three ResNet-18 steps of ``--device_cache``
(the ToTensor moved into the step) give losses and parameters bit-identical
to the host ``DataLoader`` path in float32 on the CPU: the same pixels,
the same division by 255 in float32."""

import contextlib
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.data.device_cache import DeviceCachedLoader as JaxCachedLoader
from tpudist.data.sampler import DistributedSampler as JaxSampler
from tpudist_torch.data.cifar import synthetic_cifar
from tpudist_torch.data.device_cache import DeviceCachedLoader
from tpudist_torch.data.loader import prefetch_to_device
from tpudist_torch.data.sampler import DistributedSampler
from tpudist_torch.data.transforms import device_random_crop_flip
from tpudist_torch.main import main
from tpudist_torch.train import TrainState, evaluate


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # several pytest-xdist workers share the host (tests/test_torch_train.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_index_batches_and_gather_are_the_references(drop_remainder):
    data = synthetic_cifar(37, num_classes=10)
    kw = dict(num_replicas=2, rank=1, seed=3)
    mine = DeviceCachedLoader(data, 5, device="cpu",
                              sampler=DistributedSampler(37, **kw),
                              drop_remainder=drop_remainder)
    ref = JaxCachedLoader(data, 5, sampler=JaxSampler(37, **kw),
                          drop_remainder=drop_remainder)
    assert len(mine) == len(ref) == (3 if drop_remainder else 4)
    gather, ref_gather = mine.input_transform(), ref.input_transform()
    for start in (0, 2):
        got, want = list(mine.iter_from(start)), list(ref.iter_from(start))
        assert len(got) == len(want) == len(mine) - start
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["label"], w["label"])
            assert g["image"].dtype == np.int32
            images = gather(torch.from_numpy(g["image"]), g)
            np.testing.assert_array_equal(
                images.numpy(),
                np.asarray(ref_gather(jnp.asarray(w["image"]), w)))
    assert [b["image"].tolist() for b in mine] == [
        b["image"].tolist() for b in ref]


def test_the_cache_rides_through_staging_untouched():
    data = synthetic_cifar(16, num_classes=10)
    loader = DeviceCachedLoader(data, 8, device="cpu")
    assert loader._cache.dtype == torch.uint8
    staged = list(prefetch_to_device(iter(loader), "cpu"))
    assert len(staged) == 2
    for batch in staged:
        assert batch["_cache"] is loader._cache
        assert batch["image"].shape == (8,) and batch["label"].shape == (8,)
    post = device_random_crop_flip()
    run = loader.input_transform(post)
    assert run.wants_batch and run.wants_step
    assert not loader.input_transform(lambda x: x).wants_step


def test_eval_refuses_an_augmenting_transform():
    data = synthetic_cifar(8, num_classes=10)
    loader = DeviceCachedLoader(data, 4, device="cpu")
    model = torch.nn.Linear(1, 1)
    state = TrainState(0, model, model, None)
    with pytest.raises(ValueError, match="wants_step"):
        evaluate(state, loader,
                 input_transform=loader.input_transform(
                     device_random_crop_flip()))


CLI = ["--device", "cpu", "--model", "resnet18", "--dataset", "synthetic",
       "--batch_size", "8", "--epochs", "1", "--synthetic_size", "24",
       "--no_profiler"]


def test_device_cache_is_bit_identical_to_the_host_path(tmp_path):
    runs = []
    for flags in ([], ["--device_cache"]):
        with contextlib.redirect_stdout(io.StringIO()):
            state, losses = main([*CLI, *flags, "--log_dir", str(tmp_path)])
        runs.append((losses, state.params()))
    (lh, ph), (lc, pc) = runs
    assert len(lh) == 3 and lh == lc
    for k in ph:
        assert torch.equal(ph[k], pc[k]), k


@pytest.mark.parametrize("flags", [["--augment"],
                                   ["--device_cache", "--augment"]],
                         ids=" ".join)
def test_augmented_training_runs_and_evaluates(flags, tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state, losses = main([*CLI, *flags, "--eval", "--log_dir",
                              str(tmp_path)])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert re.search(r"Accuracy: \d\.\d{4}", out.getvalue())
