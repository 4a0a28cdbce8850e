"""A frozen copy of ``scripts/train_synthetic.py make_image`` and of the
FSC147 tree writer of ``scripts/make_synthetic_fsc.py``: a synthetic
dataset in FSC147's layout (``images_384_VarV2/``,
``annotation_FSC147_384.json``, ``Train_Test_Val_FSC_147.json``,
``ImageClasses_FSC147.txt``) of dark gaussian blobs on a textured
background.

Two changes against the originals. Each blob is added over its own
+-24 px square (5.3 sigma) instead of over the whole image, which makes an
image ~20x faster to draw (the pixels differ by less than exp(-14) there).
And each image draws its own background level, spread and noise and its
blobs' depth (the originals fix them at 0.55-0.75, 0.03 and 0.55), so
that images differ from each other as photographs do: with every image
alike, a training batch's mean loss would barely move when half of the
batch is left out. The widths are drawn from the writer's ``widths``
argument."""

from __future__ import annotations

import json
import os

import numpy as np

BLOB_SIGMA = 4.5
BLOB_REACH = 24


def make_image(rng: np.random.Generator, w: int = 512, k=None, h: int = 384):
    """h x w float32 image in [0, 1] with k gaussian blobs; returns (img,
    centers (x, y))."""
    k = k if k is not None else int(rng.integers(3, 56))
    level, spread = rng.uniform(0.25, 0.85), rng.uniform(0.02, 0.3)
    noise, depth = rng.uniform(0.01, 0.1), rng.uniform(0.2, 0.7)
    img = rng.uniform(level - spread / 2, level + spread / 2, (h, w, 3)).astype(np.float32)
    img += rng.normal(0, noise, (h, w, 3)).astype(np.float32)
    centers = np.stack([rng.uniform(12, w - 12, k), rng.uniform(12, h - 12, k)], 1)
    for cx, cy in centers:
        x0, x1 = max(0, int(cx) - BLOB_REACH), min(w, int(cx) + BLOB_REACH + 1)
        y0, y1 = max(0, int(cy) - BLOB_REACH), min(h, int(cy) + BLOB_REACH + 1)
        yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
        r2 = (xx - cx) ** 2 + (yy - cy) ** 2
        img[y0:y1, x0:x1] -= depth * np.exp(-r2 / (2 * BLOB_SIGMA ** 2))[..., None]
    return np.clip(img, 0, 1), centers


def write_tree(out: str, n_train: int, n_val: int, n_test: int, seed: int, widths,
               quality: int = 95, log=print) -> None:
    """Write the tree to ``out`` (made if missing); a file ``DONE`` is
    written last, so a tree that has it is whole."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    imdir = os.path.join(out, "images_384_VarV2")
    os.makedirs(imdir, exist_ok=True)
    anno, ids = {}, []
    n_total = n_train + n_val + n_test
    for i in range(n_total):
        w = int(widths[int(rng.integers(0, len(widths)))])
        img, centers = make_image(rng, w=w)
        im_id = f"synth_{i:04d}.jpg"
        ids.append(im_id)
        Image.fromarray(np.clip(img * 255.0, 0, 255).astype(np.uint8)).save(
            os.path.join(imdir, im_id), quality=quality)
        boxes = []
        for cx, cy in centers[: min(3, len(centers))]:
            x1, y1 = max(0.0, cx - 10), max(0.0, cy - 10)
            x2, y2 = min(w - 1.0, cx + 10), min(383.0, cy + 10)
            boxes.append([[x1, y1], [x1, y2], [x2, y2], [x2, y1]])
        anno[im_id] = {"points": centers.tolist(), "box_examples_coordinates": boxes}
        if (i + 1) % 500 == 0:
            log(f"synthetic tree: {i + 1}/{n_total}")
    split = {"train": ids[:n_train], "val": ids[n_train:n_train + n_val],
             "test": ids[n_train + n_val:]}
    with open(os.path.join(out, "annotation_FSC147_384.json"), "w") as f:
        json.dump(anno, f)
    with open(os.path.join(out, "Train_Test_Val_FSC_147.json"), "w") as f:
        json.dump(split, f)
    with open(os.path.join(out, "ImageClasses_FSC147.txt"), "w") as f:
        f.write("\n".join(f"{i} blob" for i in ids))
    with open(os.path.join(out, "DONE"), "w") as f:
        f.write(f"{n_total}\n")
