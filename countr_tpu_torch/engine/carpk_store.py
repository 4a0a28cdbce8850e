"""Resident CARPK training store (counterpart of
``countr_tpu/engine/carpk_store.py``): the train split lives on the card
as uint8 originals; each step ships only an image index and the random
exemplar's 2-tap crop maps (~1.5 KB a sample).

The CARPK recipe (reference: FSC_finetune_CARPK.py:204-240) is almost
deterministic: the 384x384 train image is always the left crop of the
fixed 384x683 resize, and the density depends only on the boxes. So
unlike the FSC147 store (``engine/train_store.py``) no affine or mosaic
work is needed:

- the image resize runs on the card through static cv2-exact 2-tap maps
  (``engine/stitch.py resample_maps``), cropped to the first 384 columns;
- the density is synthesised in the step from resident dot coordinates
  (``ops/augment.py density_from_dots``, the host path's exact gaussian);
- the one random choice, which box becomes the exemplar, ships as
  per-sample 2-tap maps built on the host (the crop is at the original
  resolution with numpy's inclusive [y:y+h+1, x:x+w+1] slice, then a 64x64
  cv2 resize, reference: FSC_finetune_CARPK.py:209-223).

The card applies the two 1-D lerps one after the other, columns first and
then rows, in float32, as the JAX package does; cv2.resize arranges its
separable sum its own way. The two agree in exact arithmetic and lie
~1e-7 apart in float32 (tests/test_torch_carpk_store.py holds 2e-6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from countr_tpu_torch.engine.stitch import resample_maps
from countr_tpu_torch.engine.train_store import INV_255, upload

RES_H, RES_W = 384, 683  # the reference's resize target (FSC_test_CARPK.py:225)
CROP = 384
EX = 64  # exemplar side


@dataclasses.dataclass
class CarpkStore:
    arrays: Dict[str, torch.Tensor]  # resident device arrays
    boxes_xywh: List[np.ndarray]  # host: per-image [K, 4] for the exemplar maps
    n_images: int
    src_h: int
    src_w: int

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.arrays.values())


def build_carpk_store(src: Sequence, device, log=print) -> CarpkStore:
    """Decode and upload the whole split once. Needs uniform source image
    shapes (CARPK is 720x1280 throughout) and raises otherwise: the host
    path takes mixed shapes."""
    n = len(src)
    first = src[0]
    h0, w0 = first["image"].shape[:2]
    pix = np.zeros((n, h0, w0, 3), np.uint8)
    boxes_host: List[np.ndarray] = []
    dot_list: List[List] = []
    for i in range(n):
        s = src[i] if i else first
        if s["image"].shape != (h0, w0, 3):
            raise ValueError(
                f"--resident_data needs uniform image shapes; image {i} is "
                f"{s['image'].shape} vs {(h0, w0, 3)}: use the host path")
        pix[i] = s["image"]
        boxes_host.append(np.asarray(s["boxes_xywh"], np.float32).reshape(-1, 4))
        # the host density's dots (data/carpk.py carpk_train_sample;
        # reference: FSC_finetune_CARPK.py:229-240)
        dots = []
        for (x, y, w, h) in boxes_host[-1]:
            cx, cy = int(x + w / 2), int(y + h / 2)
            if cx < 720:
                dots.append((int(cx * 384 / 720), int(cy * 384 / 720)))
        dot_list.append(dots)
    maxk = max(1, max(len(d) for d in dot_list))
    dots_np = np.zeros((n, maxk, 2), np.int16)
    n_dots = np.zeros((n,), np.int32)
    for i, d in enumerate(dot_list):
        if d:
            dots_np[i, : len(d)] = np.asarray(d, np.int16)  # (x, y)
        n_dots[i] = len(d)

    ry0, ry1, rwy = resample_maps(h0, RES_H)
    cx0, cx1, cwx = resample_maps(w0, RES_W)
    arrays = upload({
        "pixels": pix, "dots": dots_np, "n_dots": n_dots,
        # static resize maps; the columns cropped to the left CROP outputs
        "ry0": ry0, "ry1": ry1, "rwy": rwy, "cx0": cx0[:CROP], "cx1": cx1[:CROP],
        "cwx": cwx[:CROP],
    }, device, "the CARPK store")
    log(f"[carpk-store] {n} images resident ({pix.nbytes / 1e9:.2f} GB uint8 + "
        f"{dots_np.nbytes / 1e6:.2f} MB dots) on {device}")
    return CarpkStore(arrays, boxes_host, n, h0, w0)


def exemplar_geometry(rng: np.random.Generator, store: CarpkStore,
                      idxs: np.ndarray) -> Dict[str, np.ndarray]:
    """The host's per-step randomness: one box per sample, and the 2-tap
    maps of its original-resolution crop -> 64x64 (the numpy-clamped
    inclusive slice of ``data/carpk.py _crop_resize64``)."""
    b = len(idxs)
    out = {
        "bx0": np.zeros((b, EX), np.int32), "bx1": np.zeros((b, EX), np.int32),
        "bwx": np.zeros((b, EX), np.float32),
        "by0": np.zeros((b, EX), np.int32), "by1": np.zeros((b, EX), np.int32),
        "bwy": np.zeros((b, EX), np.float32),
        "ex_valid": np.ones((b,), np.float32),
    }
    for p, i in enumerate(idxs):
        bxs = store.boxes_xywh[int(i)]
        x, y, w, h = (int(v) for v in bxs[int(rng.integers(0, len(bxs)))])
        x, y = max(x, 0), max(y, 0)
        cw = min(x + w + 1, store.src_w) - x
        ch = min(y + h + 1, store.src_h) - y
        if cw <= 0 or ch <= 0:  # a degenerate box: a zero exemplar
            out["ex_valid"][p] = 0.0
            cw = ch = 1
            x = y = 0
        out["bx0"][p], out["bx1"][p], out["bwx"][p] = resample_maps(cw, EX, x)
        out["by0"][p], out["by1"][p], out["bwy"][p] = resample_maps(ch, EX, y)
    return out


def _lerp2d(pixels, idx, x0, x1, wx, y0, y1, wy):
    """The resident images ``pixels[idx]`` ([N, H, W, 3] uint8, idx [B]),
    per-sample column maps [B, X] and row maps [B, Y] -> [B, Y, X, 3] float
    in [0, 1]: columns first, then rows."""
    b = idx.shape[0]
    rows = torch.arange(pixels.shape[1], device=pixels.device)[None, :, None]
    c0 = pixels[idx[:, None, None], rows, x0.long()[:, None, :]].float() * INV_255
    c1 = pixels[idx[:, None, None], rows, x1.long()[:, None, :]].float() * INV_255
    col = c0 + (c1 - c0) * wx[:, None, :, None]
    bi = torch.arange(b, device=pixels.device)[:, None]
    r0 = col[bi, y0.long()]
    r1 = col[bi, y1.long()]
    return r0 + (r1 - r0) * wy[:, :, None, None]


def materialize_carpk_batch(arrays: Dict, batch: Dict):
    """On the card: [B] indices and exemplar maps -> train images
    [B, 384, 384, 3] float32 and exemplar boxes [B, 3, 64, 64, 3] float32
    (the one exemplar tiled to the 3 slots; shot_num is always 1)."""
    px = arrays["pixels"]
    idx = batch["img_idx"].long()
    b = idx.shape[0]

    def fixed(k):
        return arrays[k][None].expand(b, -1)

    im = _lerp2d(px, idx, fixed("cx0"), fixed("cx1"), fixed("cwx"), fixed("ry0"), fixed("ry1"),
                 fixed("rwy"))
    ex = _lerp2d(px, idx, batch["bx0"], batch["bx1"], batch["bwx"], batch["by0"],
                 batch["by1"], batch["bwy"]) * batch["ex_valid"].reshape(b, 1, 1, 1)
    return im, ex[:, None].expand(b, 3, EX, EX, 3).contiguous()
