"""The port's batch transforms (tpudist_torch.data.transforms) against the
JAX reference's (tpudist.data.transforms).

The host augmentation is the reference's numpy code, so its stream is
held bit for bit over several batches. The normalizations are one f32
affine on both sides: within one float32 ulp of the reference (one
bfloat16 ulp after a bf16 cast, whose rounding a one-ulp f32 difference
can tip). The device crop-and-flip cannot reproduce JAX's random bits, so
it is held to its contract: every image is a reflect-padded crop of its
input at an offset in [0, 2 pad], flipped or not; the same (seed, step)
repeats and another step draws anew."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.data import transforms as R
from tpudist_torch.data import transforms as T
from torch_threads import two_torch_threads  # noqa: F401


def _images(n=16, h=8, w=8, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("pipeline", ["random_crop_flip", "standard_cifar_augment"])
def test_host_augment_stream_is_the_references(pipeline):
    make = {"random_crop_flip": lambda m: m.random_crop_flip(seed=3),
            "standard_cifar_augment": lambda m: m.standard_cifar_augment(
                seed=3, dataset="cifar100")}[pipeline]
    mine, ref = make(T), make(R)
    for b in range(3):
        batch = {"image": _images(seed=b), "label": np.arange(16)}
        got, want = mine(batch)["image"], ref(batch)["image"]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _ulps(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = np.spacing(np.abs(want).astype(np.float32))
    return float(np.max(np.abs(got - want) / ulp))


@pytest.mark.parametrize("name", ["to_tensor_normalize", "normalize"])
def test_host_normalizations_match_the_reference(name):
    mean, std = T._STATS["cifar10"]
    img = _images()
    if name == "normalize":
        img = img.astype(np.float32) / 255.0
    got = getattr(T, name)(mean, std)({"image": img})["image"]
    want = getattr(R, name)(mean, std)({"image": img})["image"]
    assert got.dtype == want.dtype == np.float32
    assert _ulps(got, want) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_normalize_matches_the_reference(dtype):
    mean, std = T._STATS["cifar100"]
    img = _images()
    tdt = getattr(torch, dtype)
    got = T.device_normalize(mean, std, tdt)(torch.from_numpy(img))
    want = np.asarray(R.device_normalize(mean, std, getattr(jnp, dtype))(
        jnp.asarray(img)).astype(jnp.float32))
    assert got.dtype == tdt
    if dtype == "float32":
        assert _ulps(got.numpy(), want) <= 1.0
    else:
        # one bf16 ulp: 2^-7 of the magnitude's binade
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
        assert np.all(np.abs(got.float().numpy() - want) <= ulp)
    # the host affine, bit for bit
    host = T.to_tensor_normalize(mean, std)({"image": img})["image"]
    np.testing.assert_array_equal(
        T.device_normalize(mean, std)(torch.from_numpy(img)).numpy(), host)


def _crop_of(out, img, pad):
    """The (y, x, flipped) at which ``out`` is a crop of ``img`` reflect-
    padded by ``pad``, or None."""
    padded = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="reflect")
    h, w, _ = img.shape
    for y in range(2 * pad + 1):
        for x in range(2 * pad + 1):
            crop = padded[y:y + h, x:x + w]
            for flipped in (False, True):
                if np.array_equal(out, crop[:, ::-1] if flipped else crop):
                    return y, x, flipped
    return None


def test_device_crop_flip_keeps_the_contract():
    img = _images(n=32, h=8, w=8)
    aug = T.device_random_crop_flip(pad=4, seed=7)
    assert aug.wants_step
    out = aug(torch.from_numpy(img), 5).numpy()
    assert out.shape == img.shape and out.dtype == np.uint8
    found = [_crop_of(o, i, 4) for o, i in zip(out, img)]
    assert all(f is not None for f in found), found
    # the draws vary across the batch: several offsets, both flips
    assert len({f[:2] for f in found}) > 4
    assert {f[2] for f in found} == {False, True}
    np.testing.assert_array_equal(aug(torch.from_numpy(img), 5).numpy(), out)
    assert not np.array_equal(aug(torch.from_numpy(img), 6).numpy(), out)
    other_seed = T.device_random_crop_flip(pad=4, seed=8)
    assert not np.array_equal(other_seed(torch.from_numpy(img), 5).numpy(), out)


def test_device_compose_hands_the_step_only_to_its_parts_that_want_it():
    seen = []

    def stepped(x, step):
        seen.append(("stepped", step))
        return x + 1

    stepped.wants_step = True

    def plain(x):
        seen.append(("plain",))
        return x * 2

    run = T.device_compose(plain, stepped)
    assert run.wants_step
    assert int(run(torch.tensor(1), 9)) == 3
    assert seen == [("plain",), ("stepped", 9)]
    assert not T.device_compose(plain).wants_step
    assert T.device_compose(plain, plain)(torch.tensor(1)) == 4
    # the reference's composite routes the same way
    assert R.device_compose(plain, stepped).wants_step
