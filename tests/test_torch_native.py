"""The port's host batcher (tpudist_torch/csrc/batcher.cpp through
tpudist_torch.data.native) against numpy and the reference's
``tpudist.data.native``: the dtype-preserving row gather and the fused
uint8 -> float32 variants (scalar and per-channel affine) bit for bit, the
index rules (negative indices wrap, out of range raises), the DataLoader's
native path batch for batch equal to its numpy path, and the refusal to
run without the library (no quiet numpy fallback)."""

import numpy as np
import pytest

from tpudist.data.native import NativeBatcher as JaxBatcher
from tpudist.data.native import native_batch as jax_native_batch
from tpudist.data.transforms import to_tensor_normalize as jax_normalize
from tpudist_torch.csrc import build
from tpudist_torch.data import native
from tpudist_torch.data.cifar import synthetic_cifar, to_tensor
from tpudist_torch.data.loader import DataLoader
from tpudist_torch.data.sampler import DistributedSampler
from tpudist_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_STD,
                                           to_tensor_normalize)


@pytest.fixture(scope="module")
def batchers():
    mine, ref = native.NativeBatcher(4), JaxBatcher(4)
    yield mine, ref
    mine.close()
    ref.close()


@pytest.mark.parametrize("dtype,shape", [
    (np.uint8, (500, 32, 32, 3)), (np.float32, (500, 17)),
    (np.int32, (500,)), (np.int64, (500, 3, 5)), (np.uint8, (2048, 3072)),
], ids=lambda v: str(v))
def test_gather_equals_numpy_and_the_reference(batchers, dtype, shape):
    mine, ref = batchers
    rng = np.random.Generator(np.random.PCG64(0))
    src = rng.integers(0, 100, shape).astype(dtype)
    idx = rng.permutation(shape[0])[:97] if shape[0] < 2048 else \
        rng.permutation(shape[0])  # > 1 MiB of rows: the threaded split
    got = mine.gather(src, idx)
    np.testing.assert_array_equal(got, src[idx])
    np.testing.assert_array_equal(got, ref.gather(src, idx))
    out = np.empty_like(got)
    assert mine.gather(src, idx, out=out) is out
    np.testing.assert_array_equal(out, got)


def test_fused_variants_equal_numpy_and_the_reference_bit_for_bit(batchers):
    mine, ref = batchers
    rng = np.random.Generator(np.random.PCG64(1))
    src = rng.integers(0, 256, (300, 16, 16, 3)).astype(np.uint8)
    idx = rng.integers(0, 300, 64)
    scale, shift = np.float32(1 / 255), np.float32(0.5)
    got = mine.gather_u8_to_f32(src, idx, scale, shift)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, src[idx].astype(np.float32) * scale
                                  + shift)
    np.testing.assert_array_equal(got, ref.gather_u8_to_f32(src, idx, scale,
                                                            shift))
    cs, csh = to_tensor_normalize(IMAGENET_MEAN, IMAGENET_STD).native_spec[
        "image"]
    got = mine.gather_u8_to_f32_channels(src, idx, cs, csh)
    np.testing.assert_array_equal(
        got, to_tensor_normalize(IMAGENET_MEAN, IMAGENET_STD)(
            {"image": src[idx]})["image"])
    np.testing.assert_array_equal(
        got, ref.gather_u8_to_f32_channels(src, idx, cs, csh))
    with pytest.raises(ValueError, match="innermost"):
        mine.gather_u8_to_f32_channels(src, idx, cs[:2], csh[:2])
    with pytest.raises(TypeError, match="uint8"):
        mine.gather_u8_to_f32(src.astype(np.int32), idx)


def test_index_rules(batchers):
    mine, _ = batchers
    src = np.arange(50, dtype=np.int64).reshape(10, 5)
    np.testing.assert_array_equal(mine.gather(src, np.array([-1, -10, 3])),
                                  src[[-1, -10, 3]])
    for bad in ([10], [-11], [0, 3, 99]):
        with pytest.raises(IndexError, match="out of range"):
            mine.gather(src, np.array(bad))
    with pytest.raises(ValueError, match="C-contiguous"):
        mine.gather(np.asfortranarray(np.zeros((4, 4))), np.array([0]))
    with pytest.raises(ValueError, match="want a C-contiguous"):
        mine.gather(src, np.array([0]), out=np.empty((2, 5), np.int64))


@pytest.mark.parametrize("transform", ["normalize", "none", "opaque"])
def test_native_batch_equals_the_references(transform):
    """native_batch over a dataset: a fused native_spec, no transform, and a
    transform without a spec (run on the gathered rows)."""
    data = synthetic_cifar(64, num_classes=10)
    idx = np.random.Generator(np.random.PCG64(2)).permutation(64)[:16]
    mine, ref = {
        "normalize": (to_tensor_normalize(IMAGENET_MEAN, IMAGENET_STD),
                      jax_normalize(IMAGENET_MEAN, IMAGENET_STD)),
        "none": (None, None),
        "opaque": (to_tensor, None),
    }[transform]
    got = native.native_batch(data, idx, mine)
    if transform == "opaque":
        # the reference's native path gives None for a transform without a
        # spec; its numpy path is the reference
        want = to_tensor({k: v[idx] for k, v in data.items()})
    else:
        want = jax_native_batch(data, idx, ref)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("transform", [None, "to_tensor", "normalize"])
def test_dataloader_native_path_equals_its_numpy_path(transform):
    data = synthetic_cifar(257, num_classes=10)
    fn = {None: None, "to_tensor": to_tensor,
          "normalize": to_tensor_normalize(IMAGENET_MEAN, IMAGENET_STD)}[
              transform]

    def loader(native_):
        return DataLoader(data, 32, transform=fn, native=native_,
                          sampler=DistributedSampler(257, num_replicas=2,
                                                     rank=1, seed=3))

    got, want = list(loader(True)), list(loader(False))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert loader(True).probe()["image"].shape == (1, 32, 32, 3)


def test_dataloader_native_refuses_what_it_cannot_gather(tmp_path,
                                                         monkeypatch):
    data = synthetic_cifar(16, num_classes=10)
    with pytest.raises(ValueError, match="C-contiguous"):
        DataLoader({"image": data["image"][:, :, ::-1],
                    "label": data["label"]}, 8)
    DataLoader({"image": data["image"][:, :, ::-1], "label": data["label"]},
               8, native=False)  # the numpy path takes it
    # no compiler: the first batch raises instead of falling back to numpy
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_default", None)
    loader = DataLoader(data, 8, transform=to_tensor)
    with pytest.raises(RuntimeError, match="cannot be built"):
        next(iter(loader))
