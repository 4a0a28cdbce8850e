"""Host-side image transforms and training augmentation (counterpart of
``countr_tpu/data/transforms.py``), on numpy arrays with the same PIL,
cv2 and native calls as the JAX package, so the two give the same bits.
Randomness comes from an explicit ``np.random.Generator`` per sample.

Images are float32 numpy HWC in [0, 1], or uint8 where named.

- Full-image resizes use PIL bilinear (antialiased), as torchvision
  Resize on PIL images (reference: util/FSC147.py:125).
- Exemplar crops are resized with cv2.INTER_LINEAR, as torchvision
  Resize on tensors (non-antialiased, half-pixel; reference:
  FSC_test_cross(few-shot).py:172).
- The photometric ops and the density synthesis take the native host
  core (``countr_tpu_torch.native``) unless ``COUNTR_TORCH_NATIVE=0``
  asks for their numpy versions, the JAX package's deterministic spec;
  the native ``gaussian_noise`` draws other bits than the numpy one.
- The affine augmentation draws the reference's parameter ranges
  (rotate +-15 deg, scale 0.8-1.2, shear +-10 deg, translate +-20%;
  reference: util/FSC147.py:150-158) into a centred matrix.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np
from PIL import Image
from scipy import ndimage

from countr_tpu_torch import native
from countr_tpu_torch.config import DENSITY_SCALE, EXEMPLAR_SIZE, IMG_SIZE

_GRAY = np.asarray([0.299, 0.587, 0.114], np.float32)


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


def flex_size(h: int, w: int, max_hw: int = IMG_SIZE) -> Tuple[int, int]:
    """Training flexible resize: bring the smaller side to 384, or snap
    both to multiples of 16 when both already exceed 384
    (reference: util/FSC147.py:102-115)."""
    if h < max_hw <= w or h <= w < max_hw:
        new_h = max_hw
        new_w = round(w * new_h / h)
    elif w < max_hw <= h or w < h < max_hw:
        new_w = max_hw
        new_h = round(h * new_w / w)
    else:
        new_w = 16 * int(w / 16)
        new_h = 16 * int(h / 16)
    return new_h, new_w


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
    util/FSC147.py:274-279 sigma=1; :332-333 sigma=4 radius=7). The
    native sparse splat equals scipy's gaussian_filter of the dot map
    (the filter is linear, the reflect boundary becomes reflected
    writes); the numpy path is that filter."""
    if native.enabled():
        return native.density_splat(np.asarray(points, np.float32).reshape(-1, 2), h, w,
                                    sigma, radius, scale)
    kw = {"sigma": sigma, "order": 0}
    if radius is not None:
        kw["radius"] = radius
    return ndimage.gaussian_filter(dot_map(points, h, w), **kw) * scale


def smooth_density(dmap: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """gaussian_filter of a (usually sparse) dot map. Dot maps have
    O(count) nonzeros, fractional after mosaic seam blending, so the
    native path splats them in O(nnz*r^2) unless the map is dense."""
    if native.enabled():
        h, w = dmap.shape
        ys, xs = np.nonzero(dmap)
        if ys.size <= (h * w) // 16:  # dense maps: scipy wins
            return native.splat_weighted(ys, xs, dmap[ys, xs], h, w, sigma, None, 1.0)
    return ndimage.gaussian_filter(dmap, sigma=sigma, order=0)


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


def crop_exemplars_u8(
    image_u8: np.ndarray,
    rects: Sequence[Sequence[int]],
    max_boxes: int = 3,
    size: int = EXEMPLAR_SIZE,
) -> np.ndarray:
    """``crop_exemplars`` of a uint8 image: slices first and converts only
    the small crops to float (the device-augmentation path keeps the full
    image uint8)."""
    out = []
    for rect in list(rects)[:max_boxes]:
        y1, x1, y2, x2 = (int(v) for v in rect)
        crop = image_u8[y1 : y2 + 1, x1 : x2 + 1].astype(np.float32) / 255.0
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


# ---------------------------------------------------------------------------
# Photometric augmentation (reference: util/FSC147.py:134-141, :371-374)
# ---------------------------------------------------------------------------


def gaussian_noise(rng: np.random.Generator, img: np.ndarray, std: float = 0.1) -> np.ndarray:
    """Additive N(0, std) noise, clipped to [0, 1]. Native: one fused pass
    whose xoshiro256++ stream is seeded from ``rng`` (deterministic per
    sample; other bits than numpy's ``rng.normal``)."""
    if native.enabled():
        out = np.ascontiguousarray(img, np.float32)
        if out is img:
            out = img.copy()
        native.noise_clip(out, std, int(rng.integers(0, 2 ** 63)))
        return out
    return np.clip(img + rng.normal(0, std, img.shape), 0.0, 1.0).astype(np.float32)


def _blend(a: np.ndarray, b, factor: float) -> np.ndarray:
    return np.clip(factor * a + (1 - factor) * b, 0.0, 1.0).astype(np.float32)


def _hue(img: np.ndarray, f: float) -> np.ndarray:
    """Rotate the hue by ``f`` of a turn through cv2's float HSV."""
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    hsv[..., 0] = (hsv[..., 0] + f * 360.0) % 360.0
    return np.clip(cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB), 0, 1)


def color_jitter(
    rng: np.random.Generator,
    img: np.ndarray,
    brightness: float = 0.25,
    contrast: float = 0.15,
    saturation: float = 0.15,
    hue: float = 0.15,
    copy: bool = True,
) -> np.ndarray:
    """torchvision ColorJitter semantics: each factor uniform around 1
    (hue in +-hue), the four ops in a random order (reference:
    util/FSC147.py:371-374). The native path makes the same draws and
    blends in place (``copy=False`` lets it mutate a caller-owned
    scratch image); hue stays on cv2 on both paths."""
    ops = list(range(4))
    rng.shuffle(ops)
    if native.enabled():
        out = np.ascontiguousarray(img, np.float32)
        if out is img and copy:
            out = img.copy()
        for op in ops:
            if op == 0:
                native.blend_scalar(out, 0.0, rng.uniform(max(0, 1 - brightness), 1 + brightness))
            elif op == 1:
                f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
                native.blend_scalar(out, native.gray_mean(out), f)
            elif op == 2:
                native.blend_gray(out, rng.uniform(max(0, 1 - saturation), 1 + saturation))
            else:
                out = _hue(out, rng.uniform(-hue, hue))
        return out
    for op in ops:
        if op == 0:  # brightness: blend with zero
            img = _blend(img, 0.0, rng.uniform(max(0, 1 - brightness), 1 + brightness))
        elif op == 1:  # contrast: blend with the mean of the grayscale
            f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
            img = _blend(img, (img @ _GRAY).mean(), f)
        elif op == 2:  # saturation: blend with the grayscale
            f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
            img = _blend(img, (img @ _GRAY)[..., None], f)
        else:
            img = _hue(img, rng.uniform(-hue, hue))
    return img.astype(np.float32)


def gaussian_blur(
    rng: np.random.Generator,
    img: np.ndarray,
    kernel: Tuple[int, int] = (7, 9),
    sigma_range: Tuple[float, float] = (0.1, 2.0),
) -> np.ndarray:
    """torchvision GaussianBlur(kernel_size=(7, 9)): kx 7, ky 9, one sigma
    ~ U(0.1, 2) for both axes (reference: util/FSC147.py:373)."""
    sigma = rng.uniform(*sigma_range)
    return cv2.GaussianBlur(
        img, ksize=kernel, sigmaX=sigma, sigmaY=sigma, borderType=cv2.BORDER_REFLECT101,
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# Geometric augmentation
# ---------------------------------------------------------------------------


def draw_affine_matrix(
    rng: np.random.Generator,
    h: int,
    w: int,
    rotate: Tuple[float, float] = (-15, 15),
    scale: Tuple[float, float] = (0.8, 1.2),
    shear: Tuple[float, float] = (-10, 10),
    translate: Tuple[float, float] = (-0.2, 0.2),
) -> np.ndarray:
    """The forward cv2 warp matrix [2, 3] of the reference's random
    affine (ranges: util/FSC147.py:150-158): scale, rotate and shear
    about the image centre, then translate."""
    ang = math.radians(rng.uniform(*rotate))
    sc = rng.uniform(*scale)
    shx = math.radians(rng.uniform(*shear))
    tx = rng.uniform(*translate) * w
    ty = rng.uniform(*translate) * h
    cx, cy = w / 2.0, h / 2.0
    cos, sin = math.cos(ang), math.sin(ang)
    rot = np.asarray([[cos, -sin], [sin, cos]])
    sh = np.asarray([[1.0, math.tan(shx)], [0.0, 1.0]])
    m2 = sh @ rot * sc
    offset = np.asarray([cx + tx, cy + ty]) - m2 @ np.asarray([cx, cy])
    return np.concatenate([m2, offset[:, None]], axis=1).astype(np.float32)


def _in_bounds(kps: np.ndarray, h: int, w: int) -> np.ndarray:
    if not kps.size:
        return np.zeros((0,), bool)
    return (kps[:, 0] >= 0) & (kps[:, 0] <= w - 1) & (kps[:, 1] >= 0) & (kps[:, 1] <= h - 1)


def warp_keypoints(
    M: np.ndarray, keypoints: np.ndarray, h: int, w: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Forward-warp (x, y) keypoints by a [2, 3] matrix; returns
    (warped, in_bounds mask)."""
    kps = keypoints @ M[:, :2].T + M[:, 2] if keypoints.size else keypoints.reshape(0, 2)
    return kps, _in_bounds(kps, h, w)


def random_affine(
    rng: np.random.Generator,
    img: np.ndarray,
    keypoints: np.ndarray,
    rotate: Tuple[float, float] = (-15, 15),
    scale: Tuple[float, float] = (0.8, 1.2),
    shear: Tuple[float, float] = (-10, 10),
    translate: Tuple[float, float] = (-0.2, 0.2),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Centred random affine of an image and its (x, y) keypoints
    (reference ranges: util/FSC147.py:150-158). Returns (image, warped
    keypoints, in_bounds mask); the image keeps its dtype (uint8 stays
    uint8: the device-augmentation geometry)."""
    h, w = img.shape[:2]
    M = draw_affine_matrix(rng, h, w, rotate, scale, shear, translate)
    m2, offset = M[:, :2].astype(np.float64), M[:, 2].astype(np.float64)
    out = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT)
    kps = keypoints @ m2.T + offset if keypoints.size else keypoints.reshape(0, 2)
    return out.astype(img.dtype), kps, _in_bounds(kps, h, w)


def hflip(img: np.ndarray, dmap: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return img[:, ::-1].copy(), dmap[:, ::-1].copy()
