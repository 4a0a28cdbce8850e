"""Host-side image transforms of the test path (counterpart of the test
subset of ``countr_tpu/data/transforms.py``), on numpy arrays with the
same PIL and cv2 calls as the JAX package, so the two give the same bits.

Images are float32 numpy HWC in [0, 1], or uint8 where named.

- Full-image resizes use PIL bilinear (antialiased), as torchvision
  Resize on PIL images (reference: util/FSC147.py:125).
- Exemplar crops are resized with cv2.INTER_LINEAR, as torchvision
  Resize on tensors (non-antialiased, half-pixel; reference:
  FSC_test_cross(few-shot).py:172).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np
from PIL import Image
from scipy import ndimage

from countr_tpu_torch.config import DENSITY_SCALE, EXEMPLAR_SIZE, IMG_SIZE


def pil_resize(img: Image.Image, h: int, w: int) -> np.ndarray:
    """PIL bilinear (antialiased) resize -> float32 HWC in [0,1]."""
    out = img.resize((w, h), Image.BILINEAR)
    return np.asarray(out, dtype=np.float32) / 255.0


def pil_resize_u8(img: Image.Image, h: int, w: int) -> np.ndarray:
    """PIL bilinear resize kept as uint8 HWC: one byte a pixel to upload;
    uint8/255 on the device gives ``pil_resize``'s values."""
    return np.asarray(img.resize((w, h), Image.BILINEAR), dtype=np.uint8)


def tensor_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Non-antialiased bilinear resize of a float HWC array
    (== torch F.interpolate align_corners=False)."""
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


def test_size(h: int, w: int) -> Tuple[int, int]:
    """Test-time geometry: H=384, W = 16*int((W/H*384)/16)
    (reference: FSC_test_cross(few-shot).py:148-149)."""
    return IMG_SIZE, 16 * int((w / h * IMG_SIZE) / 16)


def prepare_raw(
    img: Image.Image, boxes_xyxy: Sequence[Sequence[float]] = (), u8: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray], List[List[int]]]:
    """A raw image and exemplar boxes (x1, y1, x2, y2) in its own pixels
    -> (image at the test geometry, exemplar crops or None, rects
    (y1, x1, y2, x2) in resized pixels), as the test pipeline prepares
    them (reference: FSC_test_cross(few-shot).py:134-172; demo.py:34-60).
    The image is float32 in [0, 1], or uint8 with ``u8``; the crops are
    float32 either way."""
    if img.mode != "RGB":
        img = img.convert("RGB")
    w0, h0 = img.size
    nh, nw = test_size(h0, w0)
    sy, sx = nh / h0, nw / w0
    image = pil_resize_u8(img, nh, nw) if u8 else pil_resize(img, nh, nw)
    rects = [[int(y1 * sy), int(x1 * sx), int(y2 * sy), int(x2 * sx)]
             for (x1, y1, x2, y2) in boxes_xyxy]
    boxes = None
    if rects:
        unit = image.astype(np.float32) / 255.0 if u8 else image
        boxes = crop_exemplars(unit, rects, max_boxes=len(rects))
    return image, boxes, rects


def dot_map(points: np.ndarray, h: int, w: int) -> np.ndarray:
    """Binary dot map from (x, y) points, clamped to the image
    (reference: util/FSC147.py:266-268)."""
    m = np.zeros((h, w), np.float32)
    for x, y in points:
        m[min(h - 1, int(y)), min(w - 1, int(x))] = 1.0
    return m


def density_from_dots(
    points: np.ndarray, h: int, w: int, sigma: float = 1.0,
    radius: Optional[int] = None, scale: float = DENSITY_SCALE,
) -> np.ndarray:
    """Gaussian-smoothed, x60-scaled density map (reference:
    util/FSC147.py:274-279 sigma=1; :332-333 sigma=4 radius=7): scipy's
    gaussian_filter of the dot map, the JAX package's numpy formulation."""
    kw = {"sigma": sigma, "order": 0}
    if radius is not None:
        kw["radius"] = radius
    return ndimage.gaussian_filter(dot_map(points, h, w), **kw) * scale


def crop_exemplars(
    image: np.ndarray,
    rects: Sequence[Sequence[int]],
    max_boxes: int = 3,
    size: int = EXEMPLAR_SIZE,
) -> np.ndarray:
    """Crop (y1, x1, y2, x2) boxes (inclusive bounds, like the
    reference's [y1:y2+1, x1:x2+1]) and resize each to 64x64
    (reference: util/FSC147.py:281-299). Returns [k, 64, 64, 3]."""
    out = []
    for rect in list(rects)[:max_boxes]:
        y1, x1, y2, x2 = (int(v) for v in rect)
        crop = image[y1 : y2 + 1, x1 : x2 + 1]
        if crop.size == 0:
            crop = np.zeros((1, 1, 3), np.float32)
        out.append(tensor_resize(crop, size, size))
    if not out:
        return np.zeros((0, size, size, 3), np.float32)
    return np.stack(out)


def scale_rects(
    boxes: Sequence[Sequence[Sequence[float]]], sy: float, sx: float
) -> List[List[int]]:
    """Annotation box_examples_coordinates (4 corners, (x, y)) ->
    (y1, x1, y2, x2) rects in resized coords (reference:
    FSC_test_cross(few-shot).py:161-166 uses corners 0 and 2)."""
    rects = []
    for bbox in boxes:
        x1 = int(bbox[0][0] * sx)
        y1 = int(bbox[0][1] * sy)
        x2 = int(bbox[2][0] * sx)
        y2 = int(bbox[2][1] * sy)
        rects.append([y1, x1, y2, x2])
    return rects
