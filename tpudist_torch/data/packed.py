"""Pre-decoded packed image datasets: decode once, train from pixels.

The port's copy of :mod:`tpudist.data.packed`. :func:`pack_image_folder`
scans a class tree (the scan of :mod:`tpudist_torch.data.imagenet`),
decodes every image through the deterministic eval transform (the short
side resized, a center crop: the pixels of ``ImageFolderLoader(train=
False)``) and writes a fixed-shape pack:

- ``<prefix>_images.npy``: ``[N, size, size, 3]`` uint8, written through
  a memmap, so the pack never holds the dataset in RAM;
- ``<prefix>_labels.npy``: ``[N]`` int32;
- ``<prefix>_meta.json``: the class names, image size and provenance.

The files are the reference's byte for byte (apart from ``source_root``,
the absolute path of the tree). :func:`load_packed` memory-maps the pack
back as the ordinary ``{"image", "label"}`` dataset, so the array path
applies unchanged: ``DataLoader`` gathers rows through the C++ batcher,
``DeviceCachedLoader`` stages the pack on the card once, and
``RotatingDeviceCache`` streams a pack larger than the card through it in
shards. Packed pixels are the eval transform: the streaming loader's
per-epoch RandomResizedCrop does not apply (``main.py --augment`` adds a
crop and flip on the card instead).

    python -m tpudist_torch.data.packed --root /data/imagenet/train \\
        --out inpack --image_size 224
    python -m tpudist_torch.data.packed --root /data/imagenet/val \\
        --out inpack_val --image_size 224 --classes_from inpack
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from tpudist_torch.data.imagenet import _resize_center_crop, scan_image_folder


def pack_image_folder(root: str | os.PathLike, out_prefix: str | os.PathLike,
                      *, image_size: int = 224, workers: int | None = None,
                      classes: list[str] | None = None) -> dict:
    """Decode an image-folder tree once into a packed uint8 memmap.

    Returns ``{"n", "seconds", "images_per_sec", "bytes"}``: the pack rate
    is the host's sustained decode rate. Pass the train split's
    ``classes`` when packing a val split (the label contract of
    :func:`scan_image_folder`)."""
    paths, labels, classes = scan_image_folder(root, classes)
    n = len(paths)
    out_prefix = str(out_prefix)
    workers = (max(1, workers) if workers is not None
               else min(os.cpu_count() or 8, 16))

    from PIL import Image

    def decode(i: int) -> None:
        with Image.open(paths[i]) as img:
            img = _resize_center_crop(img.convert("RGB"), image_size)
            images[i] = np.asarray(img, np.uint8)

    t0 = time.perf_counter()
    images = np.lib.format.open_memmap(
        out_prefix + "_images.npy", mode="w+", dtype=np.uint8,
        shape=(n, image_size, image_size, 3))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for _ in pool.map(decode, range(n)):  # surfaces decode errors
            pass
    images.flush()
    dt = time.perf_counter() - t0
    np.save(out_prefix + "_labels.npy", np.asarray(labels, np.int32))
    meta = {
        "classes": classes,
        "image_size": image_size,
        "n": n,
        "source_root": str(Path(root).resolve()),
        "transform": "resize_short_side_256/224 + center_crop (eval)",
    }
    with open(out_prefix + "_meta.json", "w") as f:
        json.dump(meta, f)
    return {"n": n, "seconds": dt,
            "images_per_sec": n / dt if dt > 0 else float("inf"),
            "bytes": int(images.nbytes)}


def load_packed(prefix: str | os.PathLike, *, mmap: bool = True) -> dict:
    """A pack -> ``{"image": [N, s, s, 3] uint8, "label": [N] int32,
    "classes": [...]}``. ``mmap`` (the default) memory-maps the pixels:
    a gather reads only the rows it touches, so a pack larger than RAM
    still streams. A pack whose files disagree on N raises."""
    prefix = str(prefix)
    with open(prefix + "_meta.json") as f:
        meta = json.load(f)
    images = np.load(prefix + "_images.npy", mmap_mode="r" if mmap else None)
    labels = np.load(prefix + "_labels.npy")
    if images.shape[0] != meta["n"] or images.shape[0] != labels.shape[0]:
        raise ValueError(
            f"pack {prefix} is inconsistent: images {images.shape[0]} rows, "
            f"labels {labels.shape[0]}, meta n={meta['n']} — repack")
    return {"image": images, "label": labels, "classes": meta["classes"]}


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m tpudist_torch.data.packed",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="image-folder tree (root/<class>/*.jpg)")
    ap.add_argument("--out", required=True, help="output file prefix")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--classes_from", default=None,
                    help="train-split pack prefix whose class list keys the "
                    "labels (pass when packing a val split)")
    args = ap.parse_args(argv)
    classes = None
    if args.classes_from:
        with open(args.classes_from + "_meta.json") as f:
            classes = json.load(f)["classes"]
    out = pack_image_folder(args.root, args.out, image_size=args.image_size,
                            workers=args.workers, classes=classes)
    print(f"packed {out['n']} images ({out['bytes'] / 1e6:.0f} MB) in "
          f"{out['seconds']:.1f}s = {out['images_per_sec']:.0f} images/sec "
          f"sustained decode")


if __name__ == "__main__":
    main()
