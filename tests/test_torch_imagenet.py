"""The port's image-folder pipeline (tpudist_torch.data.imagenet) against
the reference's tpudist.data.imagenet on a JPEG tree the test writes (3
classes x 4 images of mixed aspect ratios): the scan and the val labels
keyed by the train classes, the train batches (RandomResizedCrop and flip
keyed by seed, epoch and position) and the eval batches (resize and center
crop) equal to the reference's float32 arrays bit for bit, ``iter_from``,
disjoint rank shards, and the crop functions' geometry on the same
images and draws."""

import numpy as np
import pytest
from PIL import Image

from tpudist.data import imagenet as J
from tpudist_torch.data import imagenet as M

SIZES = [(37, 52), (64, 64), (91, 48), (120, 80)]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgnet")
    rng = np.random.Generator(np.random.PCG64(0))
    for cls in ["cat", "dog", "eel"]:
        (root / cls).mkdir()
        for i, (w, h) in enumerate(SIZES):
            arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            Image.fromarray(arr).save(root / cls / f"img_{i}.jpg", quality=90)
    return root


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_scan_and_val_labels_are_the_references(folder, tmp_path):
    got, want = M.scan_image_folder(folder), J.scan_image_folder(folder)
    assert got[0] == want[0] and got[2] == want[2] == ["cat", "dog", "eel"]
    np.testing.assert_array_equal(got[1], want[1])
    # a val tree missing a class keeps the train split's labels
    val = tmp_path / "val"
    for cls in ["cat", "eel"]:
        (val / cls).mkdir(parents=True)
        Image.fromarray(np.zeros((40, 30, 3), np.uint8)).save(val / cls / "x.jpg")
    _, labels, classes = M.scan_image_folder(val, got[2])
    assert classes == got[2] and labels.tolist() == [0, 2]
    np.testing.assert_array_equal(labels, J.scan_image_folder(val, got[2])[1])
    (val / "zzz").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(val / "zzz" / "x.jpg")
    with pytest.raises(ValueError, match="not in the reference class list"):
        M.scan_image_folder(val, got[2])
    with pytest.raises(FileNotFoundError):
        M.scan_image_folder(tmp_path / "nope")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batches_equal_the_references(folder, train):
    kw = dict(train=train, image_size=24, seed=5, workers=3,
              drop_remainder=train)
    mine, ref = M.ImageFolderLoader(folder, 5, **kw), J.ImageFolderLoader(
        folder, 5, **kw)
    assert len(mine) == len(ref) == (2 if train else 3)
    for epoch in (0, 1):
        mine.sampler.set_epoch(epoch)
        ref.sampler.set_epoch(epoch)
        got = list(mine)
        _assert_batches_equal(got, list(ref))
        assert got[0]["image"].shape == (5, 24, 24, 3)
        _assert_batches_equal(list(mine.iter_from(1)), got[1:])
    mine.close()
    ref.close()


def test_rank_shards_are_disjoint_and_the_references(folder):
    shards = []
    for rank in range(2):
        kw = dict(train=True, image_size=16, num_replicas=2, rank=rank,
                  seed=1)
        mine = M.ImageFolderLoader(folder, 3, **kw)
        ref = J.ImageFolderLoader(folder, 3, **kw)
        _assert_batches_equal(list(mine), list(ref))
        shards.append(set(mine.sampler.epoch_indices().tolist()))
    assert not shards[0] & shards[1]
    assert shards[0] | shards[1] == set(range(12))


def test_crop_geometry_is_the_references():
    img = Image.fromarray(
        (np.arange(40 * 60 * 3) % 251).astype(np.uint8).reshape(40, 60, 3))
    for seed in range(4):
        got = M._random_resized_crop(img, 24, np.random.Generator(
            np.random.PCG64(seed)))
        want = J._random_resized_crop(img, 24, np.random.Generator(
            np.random.PCG64(seed)))
        assert got.size == (24, 24)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # degenerate aspect ratio: the central square
    thin = Image.fromarray(np.zeros((4, 300, 3), np.uint8))
    assert M._random_resized_crop(thin, 8, np.random.Generator(
        np.random.PCG64(0))).size == (8, 8)
    for shape in ((100, 300, 3), (300, 100, 3), (50, 50, 3)):
        src = Image.fromarray(np.random.Generator(np.random.PCG64(1)).integers(
            0, 256, shape).astype(np.uint8))
        got = M._resize_center_crop(src, 32)
        assert got.size == (32, 32)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(
            J._resize_center_crop(src, 32)))


def test_synthetic_imagenet_is_the_references():
    got = M.synthetic_imagenet(6, num_classes=10, image_size=32, seed=2)
    want = J.synthetic_imagenet(6, num_classes=10, image_size=32, seed=2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["image"].shape == (6, 32, 32, 3) and got["image"].dtype == np.uint8
