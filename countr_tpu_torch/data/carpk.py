"""CARPK car counting: the datasets and the train and test recipes
(counterpart of ``countr_tpu/data/carpk.py``: ``CarpkLocal``,
``CarpkHub``, ``_crop_resize64``, ``carpk_train_sample``,
``carpk_test_sample``, ``carpk_postprocess``, ``load_carpk``).

Two sources:

- "hub": the reference's Deep Lake stream (reference:
  FSC_finetune_CARPK.py:134-137 hub://activeloop/carpk-train,
  FSC_test_CARPK.py:115-117 carpk-test), where the ``hub`` client
  imports;
- "local": the standard on-disk layout (Images/*.png + Annotations/*.txt
  lines "x1 y1 x2 y2 [cls]" [+ ImageSets/<split>.txt]).

Samples mirror the hub tensors the reference consumes: RGB uint8 pixels,
boxes as (x, y, w, h), the box count as the label count.
"""

from __future__ import annotations

import os
from typing import Dict, List

import cv2
import numpy as np
from PIL import Image


class CarpkLocal:
    def __init__(self, root: str, split: str = "train"):
        self.root = root
        list_file = os.path.join(root, "ImageSets", f"{split}.txt")
        if os.path.exists(list_file):
            with open(list_file) as f:
                self.ids = [ln.strip() for ln in f if ln.strip()]
        else:
            imgs = sorted(os.listdir(os.path.join(root, "Images")))
            self.ids = [os.path.splitext(i)[0] for i in imgs]

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> Dict:
        im_id = self.ids[idx]
        img = Image.open(os.path.join(self.root, "Images", f"{im_id}.png"))
        if img.mode != "RGB":
            img = img.convert("RGB")
        boxes: List[List[float]] = []
        with open(os.path.join(self.root, "Annotations", f"{im_id}.txt")) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 4:
                    x1, y1, x2, y2 = (float(v) for v in parts[:4])
                    boxes.append([x1, y1, x2 - x1, y2 - y1])
        return {
            "image": np.asarray(img, np.uint8),
            "boxes_xywh": np.asarray(boxes, np.float32).reshape(-1, 4),
            "count": len(boxes),
            "name": im_id,
        }


class CarpkHub:
    """The Deep Lake stream ``hub://activeloop/carpk-<split>``; importing
    the ``hub`` client raises ImportError where it is not installed."""

    def __init__(self, split: str = "train"):
        import hub

        self.ds = hub.load(f"hub://activeloop/carpk-{split}")

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, idx: int) -> Dict:
        item = self.ds[idx]
        image = np.asarray(item.images.numpy(), np.uint8)
        boxes = np.asarray(item.boxes.numpy(), np.float32).reshape(-1, 4)
        labels = item.labels.numpy()
        return {
            "image": image,
            "boxes_xywh": boxes,
            "count": int(np.asarray(labels).reshape(-1).shape[0]),
            "name": str(idx),
        }


def _crop_resize64(image_f: np.ndarray, box_xywh) -> np.ndarray:
    x, y, w, h = (int(v) for v in box_xywh)
    crop = image_f[y : y + h + 1, x : x + w + 1]
    if crop.size == 0:
        crop = np.zeros((1, 1, 3), np.float32)
    return cv2.resize(crop, (64, 64), interpolation=cv2.INTER_LINEAR)


def carpk_train_sample(rng: np.random.Generator, sample: Dict) -> Dict:
    """Reference fine-tune preprocessing (FSC_finetune_CARPK.py:204-240):
    one random exemplar box cropped at the original resolution -> 64x64;
    the image resized to 384x683, then its left 384x384; the density from
    the box centres with x < 720, both axes scaled by 384/720, a sigma 1
    gaussian, x60. shot_num is 1 and the loss is unmasked."""
    from countr_tpu_torch.data import transforms as T

    image_f = sample["image"].astype(np.float32) / 255.0
    boxes = sample["boxes_xywh"]
    exemplar = _crop_resize64(image_f, boxes[int(rng.integers(0, len(boxes)))])
    image = cv2.resize(image_f, (683, 384), interpolation=cv2.INTER_LINEAR)[0:384, 0:384]
    density = np.zeros((384, 384), np.float32)
    for (x, y, w, h) in boxes:
        cx, cy = int(x + w / 2), int(y + h / 2)
        if cx < 720:
            density[int(cy * 384 / 720), int(cx * 384 / 720)] = 1.0
    density = T.smooth_density(density, sigma=1.0) * 60.0
    return {
        "image": np.ascontiguousarray(image, np.float32),
        "gt_density": density,
        "boxes": exemplar[None].repeat(3, axis=0),  # 3 slots, shot 1
        "m_flag": 1,  # shot >= 1: CARPK always trains 1-shot
        "name": sample["name"],
    }


def carpk_test_sample(sample: Dict) -> Dict:
    """Reference test preprocessing (FSC_test_CARPK.py:158-199): the
    FIRST TWO boxes as exemplars (the reference samples random indices
    but then indexes with the loop counter — kept), image resized to
    384x683."""
    image_f = sample["image"].astype(np.float32) / 255.0
    boxes = sample["boxes_xywh"]
    exemplars = np.stack(
        [_crop_resize64(image_f, boxes[i]) for i in range(min(2, len(boxes)))]
    )
    image = cv2.resize(image_f, (683, 384), interpolation=cv2.INTER_LINEAR)
    return {
        "image": np.ascontiguousarray(image, np.float32),
        "boxes": exemplars,
        "pos": boxes[: len(exemplars)],
        "count": sample["count"],
        "name": sample["name"],
    }


def carpk_postprocess(density: np.ndarray, pos: np.ndarray) -> float:
    """Reference count post-processing (FSC_test_CARPK.py:220-243):
    16x16 sum-pooling of density/60 at stride 16, minus 1 for every
    cell > 1.224, plus 2 when the exemplar-region statistic <= 0.5.
    The exemplar statistic indexes rows with the box X coordinate —
    a reference quirk reproduced verbatim."""
    h, w = density.shape
    d = density / 60.0
    ch, cw = h // 16, w // 16
    pooled = d[: ch * 16, : cw * 16].reshape(ch, 16, cw, 16).sum(axis=(1, 3))
    pred = float(pooled.sum()) - float((pooled > 1.224).sum())

    e_cnt = 0.0
    for rect in pos:
        r0, r1, r2, r3 = (int(v) for v in rect[:4])
        e_cnt += float(density[r0 : r0 + r2 + 1, r1 : r1 + r3 + 1].sum() / 60.0)
    e_cnt /= 2.0
    if e_cnt <= 0.5:
        pred += 2.0
    return pred


def load_carpk(split: str, root: str = ""):
    """The local CARPK directory ``root`` when given, else the hub stream
    (the reference's source); exits where the ``hub`` client does not
    import, as the JAX package does."""
    if root:
        return CarpkLocal(root, split)
    try:
        return CarpkHub(split)
    except ImportError as e:
        raise SystemExit(
            "CARPK: the 'hub' (Deep Lake) client is unavailable in this "
            "environment; pass --carpk_root pointing at a local CARPK "
            "directory (Images/ + Annotations/ [+ ImageSets/])"
        ) from e
