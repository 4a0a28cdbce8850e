"""FSC147 metadata and the test dataset (counterpart of ``FSC147Meta`` and
``TestDataset`` in ``countr_tpu/data/fsc147.py``). Samples are numpy
dicts, decoded and resized on the host with PIL and cv2; nothing here
touches a device.

Reference behaviour map:
- metadata files (reference: FSC_finetune_cross.py:438-451 paths,
  util/FSC147.py:22-42 class dict);
- TestDataset == the test scripts' TestData
  (reference: FSC_test_cross(few-shot).py:83-190).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from countr_tpu_torch.data import transforms as T


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
