"""FSC147 metadata and datasets (counterpart of ``countr_tpu/data/fsc147.py``:
``FSC147Meta``, ``TestDataset``, ``ValDataset`` and ``TrainDataset``).
Samples are numpy dicts, decoded, resized and augmented on the host with
PIL, cv2 and the native host core; nothing here touches a device. A
training sample's randomness is a Generator seeded by (seed, epoch,
index), so a sample is the same for any worker count or order, and
equal to the JAX package's bit for bit.

Reference behaviour map:
- metadata files (reference: FSC_finetune_cross.py:438-451 paths,
  util/FSC147.py:22-42 class dict);
- TestDataset == the test scripts' TestData
  (reference: FSC_test_cross(few-shot).py:83-190);
- ValDataset == ResizeValImage (reference: util/FSC147.py:311-357);
- TrainDataset == ResizeTrainImage (reference: util/FSC147.py:86-308);
- PretrainDataset == the MAE pretraining transform (reference:
  util/FSC147.py:360-365).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from countr_tpu_torch.config import EXEMPLAR_SIZE, IMG_SIZE, MAX_SHOTS
from countr_tpu_torch.data import transforms as T
from countr_tpu_torch.data.imcache import ImageCache


@dataclasses.dataclass
class FSC147Meta:
    """Annotation/split/class metadata (reference files:
    annotation_FSC147_384.json, Train_Test_Val_FSC_147.json,
    ImageClasses_FSC147.txt)."""

    im_dir: str
    annotations: Dict
    splits: Dict[str, List[str]]
    classes: Dict[str, List[str]]

    @classmethod
    def load(
        cls,
        data_path: str,
        anno_file: str = "annotation_FSC147_384.json",
        data_split_file: str = "Train_Test_Val_FSC_147.json",
        im_dir: str = "images_384_VarV2",
        class_file: str = "ImageClasses_FSC147.txt",
    ) -> "FSC147Meta":
        with open(os.path.join(data_path, anno_file)) as f:
            annotations = json.load(f)
        with open(os.path.join(data_path, data_split_file)) as f:
            splits = json.load(f)
        classes: Dict[str, List[str]] = {}
        class_path = os.path.join(data_path, class_file)
        if os.path.exists(class_path):
            with open(class_path) as f:
                for line in f:
                    parts = line.split()
                    if parts:
                        classes[parts[0]] = parts[1:]
        return cls(os.path.join(data_path, im_dir), annotations, splits, classes)

    def open_image(self, im_id: str) -> Image.Image:
        img = Image.open(os.path.join(self.im_dir, im_id))
        if img.mode != "RGB":
            img = img.convert("RGB")
        img.load()
        return img


def _sample_rng(seed: int, epoch: int, idx: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, epoch, idx]))


def _rects(anno: Dict, sy: float, sx: float) -> List[List[int]]:
    """The first MAX_SHOTS exemplar rects (y1, x1, y2, x2) in resized
    pixels."""
    return T.scale_rects(anno["box_examples_coordinates"][:MAX_SHOTS], sy, sx)


class TestDataset:
    """Per-image test preprocessing
    (reference: FSC_test_cross(few-shot).py:134-190): resize to H=384 /
    W=16*int((W/H*384)/16), exemplar rects scaled, crops -> 64x64;
    optional external exemplars pooled from the split's images
    (reference: :91-129) and a box_bound cap."""

    def __init__(
        self,
        meta: FSC147Meta,
        split: str = "test",
        external: bool = False,
        box_bound: int = -1,
    ):
        self.meta = meta
        self.ids = meta.splits[split]
        self.external = external
        self.box_bound = box_bound
        self.external_boxes: Optional[np.ndarray] = None
        if external:
            self.external_boxes = self._collect_external()

    def _collect_external(self) -> np.ndarray:
        pool = []
        in_split = set(self.ids)
        for im_id, anno in self.meta.annotations.items():
            if im_id not in in_split or not anno["box_examples_coordinates"]:
                continue
            img = self.meta.open_image(im_id)
            w0, h0 = img.size
            nh, nw = T.test_size(h0, w0)
            image = T.pil_resize(img, nh, nw)
            rects = T.scale_rects(anno["box_examples_coordinates"], nh / h0, nw / w0)
            pool.extend(list(T.crop_exemplars(image, rects, max_boxes=len(rects))))
        pool = pool if self.box_bound < 0 else pool[: self.box_bound]
        return np.stack(pool) if pool else np.zeros((0, 64, 64, 3), np.float32)

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> Dict:
        t0 = time.perf_counter()
        im_id = self.ids[idx]
        anno = self.meta.annotations[im_id]
        bboxes = anno["box_examples_coordinates"]
        if self.box_bound >= 0:
            bboxes = bboxes[: self.box_bound]
        dots = np.asarray(anno["points"], np.float64).reshape(-1, 2)

        img = self.meta.open_image(im_id)
        w0, h0 = img.size
        nh, nw = T.test_size(h0, w0)
        sy, sx = nh / h0, nw / w0
        # uint8 storage: exact pixels, a quarter of the float upload (the
        # engine divides by 255 on the device)
        image_u8 = T.pil_resize_u8(img, nh, nw)
        image = image_u8.astype(np.float32) / 255.0

        if self.external:
            boxes = self.external_boxes
            rects: List[List[int]] = []
        else:
            rects = T.scale_rects(bboxes, sy, sx)
            boxes = T.crop_exemplars(image, rects, max_boxes=len(rects))

        # GT map for visualization only (sigma=1, x60; reference:
        # FSC_test_cross(few-shot).py:181-187)
        gt_map = T.density_from_dots(
            np.stack([dots[:, 0] * sx, dots[:, 1] * sy], 1) if dots.size else dots,
            nh, nw, sigma=1.0,
        )
        return {
            "image": image_u8,
            "dots": dots,
            "boxes": boxes,
            "rects": rects,
            "gt_map": gt_map,
            "name": im_id,
            "load_time": time.perf_counter() - t0,
        }


# ---------------------------------------------------------------------------
# Val dataset
# ---------------------------------------------------------------------------


class ValDataset:
    """384x384 square resize; density sigma=4, radius=7, x60; exemplar
    crops and rects (reference: util/FSC147.py:311-357). Samples are
    deterministic, so whole samples are cached (the image as uint8)
    across the per-epoch validation passes."""

    def __init__(self, meta: FSC147Meta, split: str = "val"):
        self.meta = meta
        self.ids = meta.splits[split]
        self._cache = ImageCache()

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> Dict:
        im_id = self.ids[idx]
        cached = self._cache.get(im_id)
        if cached is None:
            anno = self.meta.annotations[im_id]
            dots = np.asarray(anno["points"], np.float64).reshape(-1, 2)
            img = self.meta.open_image(im_id)
            w0, h0 = img.size
            sy, sx = IMG_SIZE / h0, IMG_SIZE / w0
            u8 = T.pil_resize_u8(img, IMG_SIZE, IMG_SIZE)
            density = T.density_from_dots(
                np.stack([dots[:, 0] * sx, dots[:, 1] * sy], 1) if dots.size else dots,
                IMG_SIZE, IMG_SIZE, sigma=4.0, radius=7,
            )
            rects = _rects(anno, sy, sx)
            boxes = _pad_boxes(T.crop_exemplars(u8.astype(np.float32) / 255.0, rects))
            cached = (u8, density, boxes, rects)
            self._cache.put(im_id, cached)
        u8, density, boxes, rects = cached
        return {"image": u8.astype(np.float32) / 255.0, "gt_density": density,
                "boxes": boxes, "rects": rects, "m_flag": 0, "name": im_id}


def _pad_boxes(boxes: np.ndarray, n: int = MAX_SHOTS) -> np.ndarray:
    """The exemplar stack padded with zeros to exactly n slots (a step
    reads only the first shot_num, which never exceeds the true count)."""
    if boxes.shape[0] >= n:
        return boxes[:n]
    pad = np.zeros((n - boxes.shape[0], EXEMPLAR_SIZE, EXEMPLAR_SIZE, 3), np.float32)
    return np.concatenate([boxes, pad], 0)


# ---------------------------------------------------------------------------
# Train dataset (full augmentation)
# ---------------------------------------------------------------------------


class TrainDataset:
    """Training samples with the reference's augmentation recipe
    (reference: util/FSC147.py:117-308): gaussian noise -> colour jitter
    + blur -> random affine with dot keypoints -> horizontal flip ->
    {25% mosaic | 75% random 384 crop}; density = gaussian(sigma=1)*60;
    exemplars cropped from the *clean* resized image.

    Returns {'image' [384,384,3] float32, 'gt_density' [384,384],
    'boxes' [3,64,64,3], 'rects', 'm_flag', 'name'}. With
    ``device_aug`` the host does only the uint8 geometry and ships the dot
    coordinates ({'image_u8', 'dots', 'n_dots', 'apply_photo', 'boxes',
    ...}); the photometric chain and the density run in the training
    step (``countr_tpu_torch.ops.augment``). With ``store_index`` (the
    resident store's {image id: index}, ``engine/train_store.py``) the host
    ships only the geometry's parameters and the dot coordinates
    (``_store_item``): the card materialises the pixels."""

    # FSC147's densest image has ~3.7k dots, and a 384 crop can hold all
    # of them; int16 coordinates: 16 KB a sample.
    MAX_DEVICE_DOTS = 4096

    def __init__(self, meta: FSC147Meta, split: str = "train", do_aug: bool = True,
                 seed: int = 0, device_aug: bool = False,
                 store_index: Optional[Dict[str, int]] = None):
        self.meta = meta
        self.ids = meta.splits[split]
        self.do_aug = do_aug
        self.seed = seed
        self.epoch = 0
        self.device_aug = device_aug and do_aug
        self.store_index = store_index
        self.store_mode = store_index is not None and do_aug
        # decode + resize are deterministic per image: epochs 2+ hit this
        self._cache = ImageCache()
        self._dims_cache: Dict[str, Tuple[int, int, float, float]] = {}

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.ids)

    # -- helpers ---------------------------------------------------------

    def _load_resized_u8(self, im_id: str):
        """(uint8 image at the flex size, dots, sy, sx, nh, nw)."""
        anno = self.meta.annotations[im_id]
        dots = np.asarray(anno["points"], np.float64).reshape(-1, 2)
        cached = self._cache.get(im_id)
        if cached is None:
            img = self.meta.open_image(im_id)
            w0, h0 = img.size
            u8 = T.pil_resize_u8(img, *T.flex_size(h0, w0))
            self._cache.put(im_id, (u8, h0, w0))
        else:
            u8, h0, w0 = cached
        nh, nw = T.flex_size(h0, w0)
        return u8, dots, nh / h0, nw / w0, nh, nw

    def _load_resized(self, im_id: str):
        u8, dots, sy, sx, nh, nw = self._load_resized_u8(im_id)
        return u8.astype(np.float32) / 255.0, dots, sy, sx, nh, nw

    @staticmethod
    def _scaled_dots(dots, sy, sx, nh, nw) -> np.ndarray:
        """Integer-scaled, clamped dot coordinates (x, y): the reference's
        min(new - 1, int(dot * scale)) (util/FSC147.py:147)."""
        if not dots.size:
            return np.zeros((0, 2), np.int64)
        xs = np.minimum(nw - 1, (dots[:, 0] * sx).astype(np.int64))
        ys = np.minimum(nh - 1, (dots[:, 1] * sy).astype(np.int64))
        return np.stack([xs, ys], 1)

    def _cell_dots(self, dots, sy, sx, nh, nw, top, left, length, resize_l) -> List:
        """The dots of one mosaic cell, rescaled into it (reference:
        util/FSC147.py:190-192), as (cx, cy)."""
        pts = []
        for x, y in self._scaled_dots(dots, sy, sx, nh, nw):
            if top <= y < top + length and left <= x < left + length:
                pts.append((min(resize_l - 1, int((x - left) * resize_l / length)),
                            min(resize_l - 1, int((y - top) * resize_l / length))))
        return pts

    def _mosaic_cell_density(self, dots, sy, sx, nh, nw, top, left, length,
                             resize_l) -> np.ndarray:
        cell = np.zeros((resize_l, resize_l), np.float32)
        for cx, cy in self._cell_dots(dots, sy, sx, nh, nw, top, left, length, resize_l):
            cell[cy, cx] = 1.0
        return cell

    def _mosaic(self, rng, im_id, image, dots, sy, sx, nh, nw):
        """Self or cross mosaic (reference: util/FSC147.py:177-255)."""
        blending_l = int(rng.integers(10, 21))
        resize_l = 192 + 2 * blending_l
        cells_img: List[np.ndarray] = []
        cells_den: List[np.ndarray] = []
        m_flag = 0
        if dots.shape[0] >= 70:
            # type 1: four crops of the same image
            for _ in range(4):
                length = int(rng.integers(150, 385))
                left = int(rng.integers(0, nw - length + 1))
                top = int(rng.integers(0, nh - length + 1))
                crop = image[top : top + length, left : left + length]
                cells_img.append(T.tensor_resize(crop, resize_l, resize_l))
                cells_den.append(self._mosaic_cell_density(
                    dots, sy, sx, nh, nw, top, left, length, resize_l))
        else:
            # type 2: mixed with other train images, whose dots count only
            # for cells of the same class; 25% * 20% chance of no GT cell
            m_flag = 1
            prob = rng.random()
            gt_pos = int(rng.integers(0, 4)) if prob > 0.25 else int(rng.integers(0, 5))
            my_class = self.meta.classes.get(im_id)
            for i in range(4):
                if i == gt_pos:
                    t_id, t_img, t_dots = im_id, image, dots
                    t_sy, t_sx, t_nh, t_nw = sy, sx, nh, nw
                else:
                    t_id = self.ids[int(rng.integers(0, len(self.ids)))]
                    t_img, t_dots, t_sy, t_sx, t_nh, t_nw = self._load_resized(t_id)
                length = int(rng.integers(250, 385))
                left = int(rng.integers(0, t_nw - length + 1))
                top = int(rng.integers(0, t_nh - length + 1))
                crop = t_img[top : top + length, left : left + length]
                cells_img.append(T.tensor_resize(crop, resize_l, resize_l))
                if my_class is not None and my_class == self.meta.classes.get(t_id):
                    cells_den.append(self._mosaic_cell_density(
                        t_dots, t_sy, t_sx, t_nh, t_nw, top, left, length, resize_l))
                else:
                    cells_den.append(np.zeros((resize_l, resize_l), np.float32))
        img_out, den_out = _blend_mosaic(cells_img, cells_den, blending_l, resize_l)
        return img_out, den_out, m_flag

    def _mosaic_params(self, rng, im_id, dots, sy, sx, nh, nw):
        """The draws of ``_mosaic`` (the same rng order) without the pixel
        work: (cell image ids, tops, lefts, lengths, blend_l, the dot
        coordinates in the output, m_flag). Cells [TL, BL, TR, BR]."""
        blending_l = int(rng.integers(10, 21))
        resize_l = 192 + 2 * blending_l
        cell_ids: List[str] = []
        specs = []  # (top, left, length)
        cell_dots: List[List] = []
        m_flag = 0
        if dots.shape[0] >= 70:
            for _ in range(4):
                length = int(rng.integers(150, 385))
                left = int(rng.integers(0, nw - length + 1))
                top = int(rng.integers(0, nh - length + 1))
                cell_ids.append(im_id)
                specs.append((top, left, length))
                cell_dots.append(self._cell_dots(dots, sy, sx, nh, nw, top, left, length,
                                                 resize_l))
        else:
            m_flag = 1
            prob = rng.random()
            gt_pos = int(rng.integers(0, 4)) if prob > 0.25 else int(rng.integers(0, 5))
            my_class = self.meta.classes.get(im_id)
            for i in range(4):
                if i == gt_pos:
                    t_id, t_dots = im_id, dots
                    t_sy, t_sx, t_nh, t_nw = sy, sx, nh, nw
                else:
                    t_id = self.ids[int(rng.integers(0, len(self.ids)))]
                    t_dots = np.asarray(self.meta.annotations[t_id]["points"],
                                        np.float64).reshape(-1, 2)
                    t_nh, t_nw, t_sy, t_sx = self._flex_dims(t_id)
                length = int(rng.integers(250, 385))
                left = int(rng.integers(0, t_nw - length + 1))
                top = int(rng.integers(0, t_nh - length + 1))
                cell_ids.append(t_id)
                specs.append((top, left, length))
                same = my_class is not None and my_class == self.meta.classes.get(t_id)
                cell_dots.append(self._cell_dots(t_dots, t_sy, t_sx, t_nh, t_nw, top, left,
                                                 length, resize_l) if same else [])
        # cell dots -> output coordinates: each cell keeps rows and columns
        # [bl, resize_l - bl), shifted into its quadrant (reference:
        # util/FSC147.py:236-255; no seam blending for dots)
        bl = blending_l
        out_pts = []
        for i, pts in enumerate(cell_dots):
            col_shift = 192 if i >= 2 else 0  # cells 2, 3: the right half
            row_shift = 192 if i % 2 == 1 else 0  # cells 1, 3: the bottom half
            for cx, cy in pts:
                if bl <= cx < resize_l - bl and bl <= cy < resize_l - bl:
                    out_pts.append((cx - bl + col_shift, cy - bl + row_shift))
        out_pts = np.asarray(out_pts, np.int64).reshape(-1, 2)
        tops = np.asarray([s[0] for s in specs], np.int32)
        lefts = np.asarray([s[1] for s in specs], np.int32)
        lens = np.asarray([s[2] for s in specs], np.int32)
        return cell_ids, tops, lefts, lens, blending_l, out_pts, m_flag

    def _flex_dims(self, im_id: str):
        """(nh, nw, sy, sx) without decoding (PIL reads the size from the
        header); cached."""
        hit = self._dims_cache.get(im_id)
        if hit is None:
            with Image.open(os.path.join(self.meta.im_dir, im_id)) as img:
                w0, h0 = img.size
            nh, nw = T.flex_size(h0, w0)
            hit = self._dims_cache[im_id] = (nh, nw, nh / h0, nw / w0)
        return hit

    @staticmethod
    def _kept_dots(warped, in_bounds, nh, nw) -> List[Tuple[int, int]]:
        return [(int(x), int(y)) for (x, y), ok in zip(warped, in_bounds)
                if ok and int(y) <= nh - 1 and int(x) <= nw - 1]

    # -- device-augmentation geometry path ---------------------------------

    def _device_item(self, rng, im_id: str, anno: Dict) -> Dict:
        """uint8 geometry-only sample for the in-step device augmentation
        (``countr_tpu_torch.ops.augment``): affine, flip and crop, or the
        mosaic, on the host at uint8, and dot coordinates in place of a
        density map. Mosaic samples get ``apply_photo`` 0 (the reference's
        mosaic cells are clean, util/FSC147.py:177-255)."""
        u8, dots, sy, sx, nh, nw = self._load_resized_u8(im_id)
        m_flag = 0
        if rng.random() < 0.25:  # mosaic
            out_img, out_den, m_flag = self._mosaic(
                rng, im_id, u8.astype(np.float32) / 255.0, dots, sy, sx, nh, nw)
            out_u8 = np.clip(np.rint(out_img * 255.0), 0, 255).astype(np.uint8)
            ys, xs = np.nonzero(out_den)
            pts = np.stack([xs, ys], 1).astype(np.int32)
            apply_photo = np.float32(0.0)
        else:
            kps = self._scaled_dots(dots, sy, sx, nh, nw).astype(np.float64)
            work, warped, in_bounds = T.random_affine(rng, u8, kps)
            pts = np.asarray(self._kept_dots(warped, in_bounds, nh, nw), np.int64).reshape(-1, 2)
            if rng.random() > 0.5:  # hflip
                work = work[:, ::-1]
                if pts.size:
                    pts[:, 0] = nw - 1 - pts[:, 0]
            left = int(rng.integers(0, nw - 1 - 383 + 1))
            top = int(rng.integers(0, nh - 1 - 383 + 1))
            out_u8 = np.ascontiguousarray(work[top : top + IMG_SIZE, left : left + IMG_SIZE])
            if pts.size:
                sel = ((pts[:, 0] >= left) & (pts[:, 0] < left + IMG_SIZE)
                       & (pts[:, 1] >= top) & (pts[:, 1] < top + IMG_SIZE))
                pts = (pts[sel] - np.asarray([left, top])).astype(np.int32)
            else:
                pts = np.zeros((0, 2), np.int32)
            apply_photo = np.float32(1.0)

        k = min(pts.shape[0], self.MAX_DEVICE_DOTS)
        dots_pad = np.zeros((self.MAX_DEVICE_DOTS, 2), np.int16)
        dots_pad[:k] = pts[:k]
        boxes = _pad_boxes(T.crop_exemplars_u8(u8, _rects(anno, sy, sx)))
        return {"image_u8": out_u8, "dots": dots_pad, "n_dots": np.int32(k),
                "apply_photo": apply_photo, "boxes": boxes, "rects": [], "m_flag": m_flag,
                "name": im_id}

    # -- resident-store parameter path -------------------------------------

    def _store_item(self, rng, im_id: str, anno: Dict) -> Dict:
        """Parameters-only sample of the resident-store mode
        (``engine/train_store.py``): the card materialises the pixels; the
        host ships ~100 bytes of geometry and the dot coordinates. The same
        draws, in the same order, as the JAX package's."""
        from countr_tpu_torch.engine.train_store import compose_affine

        nh, nw, sy, sx = self._flex_dims(im_id)
        dots = np.asarray(anno["points"], np.float64).reshape(-1, 2)
        idx = self.store_index[im_id]
        if rng.random() < 0.25:  # mosaic
            cell_ids, tops, lefts, lens, bl, pts, m_flag = self._mosaic_params(
                rng, im_id, dots, sy, sx, nh, nw)
            cell_idx = np.asarray([self.store_index[c] for c in cell_ids], np.int32)
            C, d = np.eye(2, dtype=np.float32), np.zeros(2, np.float32)
            is_mosaic = np.float32(1.0)
        else:
            m_flag = 0
            M = T.draw_affine_matrix(rng, nh, nw)
            kps = self._scaled_dots(dots, sy, sx, nh, nw).astype(np.float64)
            warped, in_bounds = T.warp_keypoints(M, kps, nh, nw)
            pts = np.asarray(self._kept_dots(warped, in_bounds, nh, nw), np.int64).reshape(-1, 2)
            flip = rng.random() > 0.5
            if flip and pts.size:
                pts[:, 0] = nw - 1 - pts[:, 0]
            left = int(rng.integers(0, nw - 1 - 383 + 1))
            top = int(rng.integers(0, nh - 1 - 383 + 1))
            if pts.size:
                sel = ((pts[:, 0] >= left) & (pts[:, 0] < left + IMG_SIZE)
                       & (pts[:, 1] >= top) & (pts[:, 1] < top + IMG_SIZE))
                pts = pts[sel] - np.asarray([left, top])
            C, d = compose_affine(M, flip, left, top, nw)
            cell_idx = np.full(4, idx, np.int32)
            tops, lefts = np.zeros(4, np.int32), np.zeros(4, np.int32)
            lens = np.full(4, IMG_SIZE, np.int32)
            bl = 10
            is_mosaic = np.float32(0.0)

        k = min(pts.shape[0], self.MAX_DEVICE_DOTS)
        dots_pad = np.zeros((self.MAX_DEVICE_DOTS, 2), np.int16)
        dots_pad[:k] = pts[:k]
        return {"img_idx": np.int32(idx), "affine_C": C, "affine_d": d,
                "is_mosaic": is_mosaic, "cell_idx": cell_idx, "cell_top": tops,
                "cell_left": lefts, "cell_len": lens, "blend_l": np.int32(bl),
                "dots": dots_pad, "n_dots": np.int32(k), "m_flag": m_flag, "name": im_id,
                "rects": []}

    # -- main ------------------------------------------------------------

    def __getitem__(self, idx: int) -> Dict:
        rng = _sample_rng(self.seed, self.epoch, idx)
        im_id = self.ids[idx]
        anno = self.meta.annotations[im_id]
        if self.store_mode:
            return self._store_item(rng, im_id, anno)
        if self.device_aug:
            return self._device_item(rng, im_id, anno)
        image, dots, sy, sx, nh, nw = self._load_resized(im_id)
        m_flag = 0
        rects_out: List[List[int]] = []

        if self.do_aug:
            mosaic = rng.random() < 0.25
            # photometric and geometric augmentation of a working copy
            work = T.gaussian_noise(rng, image)
            work = T.color_jitter(rng, work, copy=False)  # work is scratch
            work = T.gaussian_blur(rng, work)
            kps = self._scaled_dots(dots, sy, sx, nh, nw).astype(np.float64)
            work, warped, in_bounds = T.random_affine(rng, work, kps)
            density = np.zeros((nh, nw), np.float32)
            for x, y in self._kept_dots(warped, in_bounds, nh, nw):
                density[y, x] = 1.0
            if rng.random() > 0.5:
                work, density = T.hflip(work, density)
            if mosaic:
                out_img, out_den, m_flag = self._mosaic(rng, im_id, image, dots, sy, sx, nh, nw)
            else:
                left = int(rng.integers(0, nw - 1 - 383 + 1))
                top = int(rng.integers(0, nh - 1 - 383 + 1))
                out_img = work[top : top + IMG_SIZE, left : left + IMG_SIZE]
                out_den = density[top : top + IMG_SIZE, left : left + IMG_SIZE]
        else:
            density = np.zeros((nh, nw), np.float32)
            for x, y in self._scaled_dots(dots, sy, sx, nh, nw):
                density[y, x] = 1.0
            start = int(rng.integers(0, nw - IMG_SIZE + 1))
            out_img = image[0:IMG_SIZE, start : start + IMG_SIZE]
            out_den = density[0:IMG_SIZE, start : start + IMG_SIZE]

        out_den = T.smooth_density(out_den, sigma=1.0) * 60.0

        # exemplars from the clean resized image (reference:
        # util/FSC147.py:281-299); rects only on the path without augmentation
        rects = _rects(anno, sy, sx)
        if not self.do_aug:
            rects_out = [[y1, max(0, x1 - start), y2, min(IMG_SIZE, x2 - start)]
                         for y1, x1, y2, x2 in rects]
        boxes = _pad_boxes(T.crop_exemplars(image, rects))
        return {
            "image": np.ascontiguousarray(out_img, np.float32),
            "gt_density": np.ascontiguousarray(out_den, np.float32),
            "boxes": boxes,
            "rects": rects_out,
            "m_flag": m_flag,
            "name": im_id,
        }


def _blend_mosaic(cells_img, cells_den, bl: int, resize_l: int):
    """2x2 mosaic assembly with linear alpha blending at the seams
    (reference: util/FSC147.py:236-255). Cells [0 top-left, 1 bottom-left,
    2 top-right, 3 bottom-right]; each contributes its central 192x192
    plus ``bl`` pixels of blend margin."""

    def vpair(a_img, b_img, a_den, b_den):
        img = np.concatenate([a_img[bl : resize_l - bl], b_img[bl : resize_l - bl]], axis=0)
        den = np.concatenate([a_den[bl : resize_l - bl], b_den[bl : resize_l - bl]], axis=0)
        for i in range(bl):
            w_in = (bl - i) / (2 * bl)
            w_keep = (i + bl) / (2 * bl)
            img[192 + i] = a_img[resize_l - 1 - bl + i] * w_in + img[192 + i] * w_keep
            img[191 - i] = b_img[bl - i] * w_in + img[191 - i] * w_keep
        return np.clip(img, 0, 1), den

    left_img, left_den = vpair(cells_img[0], cells_img[1], cells_den[0], cells_den[1])
    right_img, right_den = vpair(cells_img[2], cells_img[3], cells_den[2], cells_den[3])
    img = np.concatenate(
        [left_img[:, bl : resize_l - bl], right_img[:, bl : resize_l - bl]], axis=1)
    den = np.concatenate(
        [left_den[:, bl : resize_l - bl], right_den[:, bl : resize_l - bl]], axis=1)
    for i in range(bl):
        w_in = (bl - i) / (2 * bl)
        w_keep = (i + bl) / (2 * bl)
        img[:, 192 + i] = left_img[:, resize_l - 1 - bl + i] * w_in + img[:, 192 + i] * w_keep
        img[:, 191 - i] = right_img[:, bl - i] * w_in + img[:, 191 - i] * w_keep
    return np.clip(img, 0, 1).astype(np.float32), den.astype(np.float32)


# ---------------------------------------------------------------------------
# MAE pretrain dataset
# ---------------------------------------------------------------------------


class PretrainDataset:
    """RandomResizedCrop(img_size, scale=(0.2, 1.0), bicubic) + horizontal
    flip over the train split's images (reference: util/FSC147.py:360-365,
    which crops 384; ``img_size`` is the model's, 378 for ViT-H/14).

    Returns {'image' [img_size, img_size, 3] float32, 'name'}. With
    ``store`` (the resident store's host catalog, ``engine/train_store.py
    PretrainStore.catalog``) the host ships only the crop's scalars
    (``_store_item``, ~30 bytes a sample) and the card materialises the
    pixels at the model's size. The crop's draw does not depend on
    ``img_size``."""

    def __init__(self, meta: FSC147Meta, split: str = "train", seed: int = 0, store=None,
                 img_size: int = IMG_SIZE):
        self.meta = meta
        self.img_size = img_size
        self.ids = meta.splits[split]
        self.seed = seed
        self.epoch = 0
        self.store = store
        # the random crop samples the decoded original: epochs 2+ hit this
        self._cache = ImageCache()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.ids)

    @staticmethod
    def sample_crop(rng, h0: int, w0: int) -> Tuple[int, int, int, int]:
        """torchvision's RandomResizedCrop draw (top, left, h, w): 10
        attempts of (area scale, log-ratio), then the ratio-clamped maximal
        centre crop (reference transform: util/FSC147.py:361-363 through
        ``RandomResizedCrop.get_params``)."""
        area = h0 * w0
        min_ratio, max_ratio = 3 / 4, 4 / 3
        for _ in range(10):
            target = area * rng.uniform(0.2, 1.0)
            ar = math.exp(rng.uniform(math.log(min_ratio), math.log(max_ratio)))
            cw = int(round(math.sqrt(target * ar)))
            ch = int(round(math.sqrt(target / ar)))
            if 0 < cw <= w0 and 0 < ch <= h0:
                left = int(rng.integers(0, w0 - cw + 1))
                top = int(rng.integers(0, h0 - ch + 1))
                return top, left, ch, cw
        in_ratio = w0 / h0
        if in_ratio < min_ratio:
            cw = w0
            ch = int(round(cw / min_ratio))
        elif in_ratio > max_ratio:
            ch = h0
            cw = int(round(ch * max_ratio))
        else:
            cw, ch = w0, h0
        return (h0 - ch) // 2, (w0 - cw) // 2, ch, cw

    def _store_item(self, rng, idx: int) -> Dict:
        """The crop's scalars in the store's geometry: the smaller side is
        384 there and a portrait is stored transposed, so its crop's
        coordinates swap."""
        st = self.store
        i = st.index[self.ids[idx]]
        w = int(st.w_np[i])
        transposed = int(st.t_np[i])
        # the original's dims: a landscape is (384, w); a portrait (w, 384)
        h0, w0 = (w, IMG_SIZE) if transposed else (IMG_SIZE, w)
        top, left, ch, cw = self.sample_crop(rng, h0, w0)
        if transposed:
            top, left, ch, cw = left, top, cw, ch
        flip = int(rng.random() < 0.5)
        return {"img_idx": np.int32(i), "crop_top": np.int32(top), "crop_left": np.int32(left),
                "crop_h": np.int32(ch), "crop_w": np.int32(cw),
                "transposed": np.int8(transposed), "flip": np.int8(flip),
                "name": self.ids[idx]}

    def __getitem__(self, idx: int) -> Dict:
        rng = _sample_rng(self.seed, self.epoch, idx)
        if self.store is not None:
            return self._store_item(rng, idx)
        cached = self._cache.get(self.ids[idx])
        if cached is None:
            img = self.meta.open_image(self.ids[idx])
            self._cache.put(self.ids[idx], (np.asarray(img, np.uint8),))
        else:
            img = Image.fromarray(cached[0])
        w0, h0 = img.size
        top, left, ch, cw = self.sample_crop(rng, h0, w0)
        crop = img.crop((left, top, left + cw, top + ch)).resize(
            (self.img_size, self.img_size), Image.BICUBIC)
        out = np.asarray(crop, np.float32) / 255.0
        if rng.random() < 0.5:
            out = out[:, ::-1].copy()
        return {"image": out, "name": self.ids[idx]}
