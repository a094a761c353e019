"""The port's packed datasets (tpudist_torch.data.packed) against the
reference's tpudist.data.packed: ``pack_image_folder``'s ``_images.npy``
and ``_labels.npy`` byte-identical to the reference's, ``_meta.json``
equal apart from ``source_root``; ``load_packed``'s memmap round trip and
its refusal of an inconsistent pack; a val pack keyed by the train pack's
classes through the CLI's ``--classes_from``."""

import json

import numpy as np
import pytest
from PIL import Image

from tpudist.data.packed import main as jax_pack_main
from tpudist.data.packed import pack_image_folder as jax_pack
from tpudist_torch.data.imagenet import ImageFolderLoader
from tpudist_torch.data.packed import load_packed, main, pack_image_folder


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """train/ with 3 classes x 4 images of mixed sizes; val/ missing one
    class."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.Generator(np.random.PCG64(0))
    for split, classes in (("train", ["cat", "dog", "eel"]),
                           ("val", ["cat", "eel"])):
        for ci, cls in enumerate(classes):
            (root / split / cls).mkdir(parents=True)
            for i in range(4):
                w, h = int(rng.integers(30, 70)), int(rng.integers(30, 70))
                arr = (rng.integers(0, 60, (h, w, 3)) + 60 * ci).astype(
                    np.uint8)
                Image.fromarray(arr).save(root / split / cls / f"{i}.jpg")
    return root


def test_pack_files_are_the_references(tree, tmp_path):
    got = pack_image_folder(tree / "train", tmp_path / "p", image_size=20,
                            workers=2)
    jax_pack(tree / "train", tmp_path / "r", image_size=20, workers=2)
    assert got["n"] == 12 and got["bytes"] == 12 * 20 * 20 * 3
    for suffix in ("_images.npy", "_labels.npy"):
        assert (tmp_path / f"p{suffix}").read_bytes() == (
            tmp_path / f"r{suffix}").read_bytes()
    meta = json.loads((tmp_path / "p_meta.json").read_text())
    want = json.loads((tmp_path / "r_meta.json").read_text())
    assert meta.pop("source_root") == str((tree / "train").resolve())
    want.pop("source_root")
    assert meta == want


def test_load_packed_round_trips_and_refuses_an_inconsistent_pack(tree,
                                                                  tmp_path):
    pack_image_folder(tree / "train", tmp_path / "p", image_size=16)
    data = load_packed(tmp_path / "p")
    assert isinstance(data["image"], np.memmap)
    assert data["image"].shape == (12, 16, 16, 3)
    assert data["classes"] == ["cat", "dog", "eel"]
    # the pixels are the streaming eval loader's, before normalization
    stream = ImageFolderLoader(tree / "train", 12, train=False, image_size=16,
                               normalize=False)
    batch = next(iter(stream))
    np.testing.assert_array_equal(np.asarray(data["image"]), batch["image"])
    np.testing.assert_array_equal(data["label"], batch["label"])
    full = load_packed(tmp_path / "p", mmap=False)
    assert not isinstance(full["image"], np.memmap)
    np.save(tmp_path / "p_labels.npy", data["label"][:5])
    with pytest.raises(ValueError, match="inconsistent"):
        load_packed(tmp_path / "p")


def test_val_pack_is_keyed_by_the_train_classes(tree, tmp_path, capsys):
    main(["--root", str(tree / "train"), "--out", str(tmp_path / "tr"),
          "--image_size", "16"])
    main(["--root", str(tree / "val"), "--out", str(tmp_path / "va"),
          "--image_size", "16", "--classes_from", str(tmp_path / "tr")])
    assert "packed 8 images" in capsys.readouterr().out
    jax_pack_main(["--root", str(tree / "val"), "--out",
                   str(tmp_path / "rv"), "--image_size", "16",
                   "--classes_from", str(tmp_path / "tr")])
    val = load_packed(tmp_path / "va")
    assert val["classes"] == ["cat", "dog", "eel"]
    assert sorted(set(val["label"].tolist())) == [0, 2]  # eel keeps 2
    for suffix in ("_images.npy", "_labels.npy"):
        assert (tmp_path / f"va{suffix}").read_bytes() == (
            tmp_path / f"rv{suffix}").read_bytes()
