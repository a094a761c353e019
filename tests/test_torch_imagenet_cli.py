"""``python -m tpudist_torch.main --dataset imagenet`` on the CPU against the
reference's ``main.py`` on the same data: a pack written here from
``synthetic_imagenet`` at 32x32 with numpy alone, and a JPEG tree. The
models are ResNet-18 and a ViT with 16-pixel patches at ``--image_size
32``, narrowed on both sides to keep the steps cheap, the port's weights
loaded from the reference's init. Compared: ResNet-18 through the pack's
host loader with ``--packed_val --eval`` and through the rotating device
cache (``--cache_shard_rows``); the ViT through the streaming image
folder with ``--eval``, and its first step through the pack. Then the
port's ``--packed --device_cache --augment``, and the ``--cache_shard_rows``
guard and the ``--packed_val`` class check, which raise as the
reference's do.

The reference runs on the suite's 8 emulated devices with ``--batch_size
1`` (8 images a step), the port in one process with ``--batch_size 8``:
the same global batches. Bars, set before the first run: ResNet-18's
losses within 1e-4 relative (the trainer bar of tests/test_torch_train.py:
float32 BatchNorm over other reduction orders), the ViT's within 1e-5
(tests/test_torch_vit.py's fit bar). The TSV rows' ``g_img`` are equal and
their losses within the same bars; neither file has an ``HBM`` row on the
CPU.

The ViT on the pack is held at its first loss only. Its first run missed
the 1e-5 bar from step 2 on (3.5e-5): the reference normalizes a pack's
pixels in its jitted step, where XLA:CPU's fused ``x * scale + shift``
rounds 34-40% of them one float32 ulp away from the two roundings of its
own host path, which the port's ``device_normalize`` keeps; Adam carries
that into the losses. On identical inputs (host-normalized) the two agree
to 1e-7 over six steps, and the streaming folder below, which normalizes
on the host in both, holds the ViT at 1e-5 over every step."""

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta
from PIL import Image

import tpudist.models as jax_models
from tpudist import mesh as mesh_lib
from tpudist.train import create_train_state as jax_create_train_state
from tpudist_torch.data.imagenet import synthetic_imagenet
from tpudist_torch.interop import resnet_params_from_flax, vit_params_from_flax
from tpudist_torch.main import main
from tpudist_torch.models import resnet, vit

REPO = Path(__file__).resolve().parent.parent
VIT = dict(hidden_dim=32, depth=2, num_heads=2, mlp_dim=64)
CLASSES = [f"n{i:08d}" for i in range(10)]
BARS = {"resnet18": 1e-4, "vit_b16": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def write_pack(prefix: Path, n: int, classes, seed: int) -> Path:
    """A pack in ``tpudist.data.packed``'s format, from numpy alone."""
    import json

    data = synthetic_imagenet(n, num_classes=len(CLASSES), image_size=32,
                              seed=seed)
    images = np.lib.format.open_memmap(f"{prefix}_images.npy", mode="w+",
                                       dtype=np.uint8, shape=data["image"].shape)
    images[:] = data["image"]
    images.flush()
    np.save(f"{prefix}_labels.npy", data["label"])
    Path(f"{prefix}_meta.json").write_text(json.dumps(
        {"classes": list(classes), "image_size": 32, "n": n,
         "source_root": "synthetic", "transform": "synthetic"}))
    return prefix


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    root = tmp_path_factory.mktemp("packs")
    return {"train": write_pack(root / "tr", 48, CLASSES, 0),
            "val": write_pack(root / "va", 12, CLASSES, 1),
            "other": write_pack(root / "ot", 12, CLASSES[::-1], 1)}


def _reference_main():
    spec = importlib.util.spec_from_file_location("reference_main",
                                                  REPO / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _narrow(monkeypatch, model):
    """Both CLIs build ``model`` narrowed; the port's from the reference's
    init (``fit``'s seed 0 on a 32x32 input)."""
    mesh = mesh_lib.create_mesh(devices=jax.devices()[:1])
    if model == "resnet18":
        build = jax_models.resnet18
        monkeypatch.setattr(jax_models, "resnet18",
                            lambda **kw: build(num_filters=8, **kw))
        js = jax_create_train_state(build(num_filters=8), 0,
                                    jnp.zeros((1, 32, 32, 3)),
                                    optax.adam(1e-3), mesh)
        init = resnet_params_from_flax(
            jax.tree_util.tree_map(np.asarray, js.params),
            jax.tree_util.tree_map(np.asarray, js.batch_stats))
        port, attr = resnet, "resnet18"
        narrow = dict(num_filters=8)
    else:
        build = jax_models.vit_b16
        monkeypatch.setattr(jax_models, "vit_b16",
                            lambda **kw: build(**VIT, **kw))
        js = jax_create_train_state(build(**VIT, patch_size=16), 0,
                                    jnp.zeros((1, 32, 32, 3)),
                                    optax.adam(1e-3), mesh)
        init = vit_params_from_flax(jax.tree_util.tree_map(
            np.asarray, meta.unbox(js.params)))
        port, attr = vit, "vit_b16"
        narrow = VIT
    inner = getattr(port, attr)

    def built(**kw):
        m = inner(**narrow, **kw)
        m.load_state_dict(init)
        return m

    monkeypatch.setattr(port, attr, built)


def _rows(path):
    lines = path.read_text().splitlines()
    assert lines[0] == "datetime\tg_step\tg_img\tloss_value\texamples_per_sec"
    assert lines[-1].startswith("TrainTime\t")
    assert not any(line.startswith("HBM") for line in lines)
    return [(int(f[2]), float(f[3])) for f in
            (line.split("\t") for line in lines[1:-1])]


def _run(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, losses = fn(argv)
    return losses, out.getvalue()


def _tree(root: Path, n_train: int, n_val: int) -> Path:
    """A JPEG tree of 3 classes: ``train/`` and ``val/``."""
    rng = np.random.Generator(np.random.PCG64(0))
    for split, n in (("train", n_train), ("val", n_val)):
        for cls in CLASSES[:3]:
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                h, w = int(rng.integers(24, 60)), int(rng.integers(24, 60))
                Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(
                    np.uint8)).save(d / f"{i}.jpg")
    return root


@pytest.mark.parametrize("model,flags,steps", [
    ("resnet18", ["--packed", "train", "--packed_val", "val", "--eval"], 6),
    ("resnet18", ["--packed", "train", "--device_cache", "--cache_shard_rows",
                  "16"], 6),
    ("vit_b16", ["--data_root", "tree", "--workers", "2", "--eval"], 6),
    ("vit_b16", ["--packed", "train"], 1),
], ids=["resnet18-packed-eval", "resnet18-rotation", "vit-folder-eval",
        "vit-packed-first-step"])
def test_cli_matches_the_reference_cli(model, flags, steps, packs, tmp_path,
                                       monkeypatch):
    _narrow(monkeypatch, model)
    where = {"train": packs["train"], "val": packs["val"],
             "tree": _tree(tmp_path / "tree", 16, 2) if "tree" in flags
             else None}
    flags = [str(where[f]) if f in where else f for f in flags]
    common = ["--model", model, "--dataset", "imagenet", "--image_size", "32",
              "--epochs", "1", "--no_profiler", *flags]
    want, want_out = _run(_reference_main(), [
        *common, "--batch_size", "1", "--log_dir", str(tmp_path / "ref")])
    got, got_out = _run(main, [*common, "--device", "cpu", "--batch_size", "8",
                               "--log_dir", str(tmp_path / "port")])
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got[:steps], want[:steps], rtol=BARS[model])
    got_rows = _rows(tmp_path / "port" / "Job0_8_0.log")
    want_rows = _rows(tmp_path / "ref" / "Job0_1_0.log")
    assert [g for g, _ in got_rows] == [g for g, _ in want_rows] == [40]
    if steps == 6:
        np.testing.assert_allclose([v for _, v in got_rows],
                                   [v for _, v in want_rows],
                                   rtol=BARS[model])
    if "--eval" in flags:
        acc = [re.search(r"Accuracy: (\d\.\d{4})", o).group(1)
               for o in (got_out, want_out)]
        assert acc[0] == acc[1]


def test_device_cache_augment(packs, tmp_path, monkeypatch):
    """The crop and flip in the step draw from the port's own generator
    (no bit parity with JAX's), so the run is held to its own contract:
    six finite steps and the TSV."""
    _narrow(monkeypatch, "resnet18")
    losses, _ = _run(main, [
        "--device", "cpu", "--model", "resnet18", "--dataset", "imagenet",
        "--image_size", "32", "--batch_size", "8", "--epochs", "1",
        "--no_profiler", "--packed", str(packs["train"]), "--device_cache",
        "--augment", "--log_dir", str(tmp_path)])
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert [g for g, _ in _rows(tmp_path / "Job0_8_0.log")] == [40]


def test_guards_raise_as_the_references(packs, tmp_path, monkeypatch):
    _narrow(monkeypatch, "resnet18")
    reference = _reference_main()
    common = ["--model", "resnet18", "--epochs", "1", "--no_profiler",
              "--log_dir", str(tmp_path)]
    for flags in (["--dataset", "synthetic", "--cache_shard_rows", "8"],
                  ["--dataset", "imagenet", "--packed", str(packs["train"]),
                   "--cache_shard_rows", "8"]):
        with pytest.raises(SystemExit) as want:
            reference([*common, *flags])
        with pytest.raises(SystemExit) as got:
            main([*common, "--device", "cpu", *flags])
        assert str(got.value) == str(want.value)
        assert "--cache_shard_rows rotates the packed HBM cache" in str(
            got.value)
    flags = ["--dataset", "imagenet", "--image_size", "32", "--packed",
             str(packs["train"]), "--packed_val", str(packs["other"]),
             "--eval", "--batch_size", "8"]
    with pytest.raises(SystemExit, match="--packed_val class list does not "
                       "match the training classes.*tpudist_torch.data."
                       "packed --classes_from"):
        main([*common, "--device", "cpu", *flags])
