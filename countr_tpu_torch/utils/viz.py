"""Visual outputs of the inference CLIs (counterpart of ``box_map``,
``make_grid``, ``save_prediction_panel``, ``save_exemplar_strip``,
``save_results``, ``frames_to_video``, ``write_zeroshot_annotations``,
``write_annotations_gt`` and ``write_predicted_points`` in
``countr_tpu/utils/viz.py``), on the host with PIL, cv2 and numpy.

They cover the reference's artifacts: exemplar box overlays (reference:
util/misc.py:534-542 get_box_map), the 3x3 grid-mode density composite
(util/misc.py:509-517 make_grid), prediction/GT overlay panels
(FSC_test_cross(few-shot).py:379-421), results.csv and the error
scatter (:447-453). results.csv is written with the csv module (the JAX
package uses pandas, which the port does not need); the scatter plot is
drawn when matplotlib imports.
"""

from __future__ import annotations

import csv
import json
import os
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

from countr_tpu_torch.data.transforms import tensor_resize


def box_map(
    image_hw: Sequence[int], rects: Sequence[Sequence[int]], external: bool = False
) -> np.ndarray:
    """Green exemplar-box outline layer [H, W, 3]
    (reference: util/misc.py:534-542; skipped for external exemplars)."""
    h, w = image_hw
    out = np.zeros((h, w, 3), np.float32)
    if external:
        return out
    for rect in list(rects)[:3]:
        y1, x1, y2, x2 = (int(v) for v in rect)
        y1, y2 = max(0, y1), min(h - 1, y2)
        x1, x2 = max(0, x1), min(w - 1, x2)
        out[y1 : y2 + 1, [x1, x2], 1] = 1.0
        out[[y1, y2], x1 : x2 + 1, 1] = 1.0
    return out


def make_grid(densities: List[np.ndarray], h: int, w: int) -> np.ndarray:
    """Compose 9 grid-crop density maps into one [h, w] panel in the
    reference's crop order (reference: util/misc.py:509-517)."""
    out = np.zeros((h, w), np.float32)
    h3, w3 = h // 3, w // 3
    order = [
        (0, 0), (h3, 0), (0, w3), (h3, w3), (2 * h // 3, 0), (2 * h // 3, w3),
        (0, 2 * w // 3), (h3, 2 * w // 3), (2 * h // 3, 2 * w // 3),
    ]
    for d, (t, l) in zip(densities, order):
        out[t : t + h3, l : l + w3] = tensor_resize(d, h3, w3)
    return out


def _to_pil(img: np.ndarray) -> Image.Image:
    return Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))


def save_prediction_panel(
    path: str,
    image: np.ndarray,
    density: np.ndarray,
    gt_map: Optional[np.ndarray],
    rects: Sequence[Sequence[int]],
    pred_cnt: float,
    gt_cnt: Optional[float] = None,
    external: bool = False,
) -> None:
    """Side-by-side overlay panel: |pred-gt| mix, image+boxes+labels,
    TP overlay (reference: FSC_test_cross(few-shot).py:379-421
    structure, simplified color scheme kept: red=density, green=TP)."""
    h, w = image.shape[:2]
    pred_rgb = np.stack([density, density, np.zeros_like(density)], -1)
    if gt_map is not None and gt_cnt:
        gt_rgb = np.stack([gt_map, np.zeros_like(gt_map), np.zeros_like(gt_map)], -1)
        fp = np.where((gt_rgb - pred_rgb) < -0.01, pred_rgb, 0.0)
        tp = image * 0.6 + (pred_rgb - fp)[..., [1, 0, 2]]
        mix = image * 0.6 + np.abs(np.clip(pred_rgb, 0, 1) - np.clip(gt_rgb, 0, 1))
        sam_box = np.clip(image + box_map((h, w), rects, external), 0, 1)
        panels = [mix, sam_box, tp]
        texts = [f"GT: {gt_cnt:.3f}", f"Pred: {pred_cnt:.3f}"]
    else:
        sam_box = np.clip(image + box_map((h, w), rects, external), 0, 1)
        den_pr = np.clip(image * 0.6 + pred_rgb, 0, 1)
        panels = [sam_box, den_pr]
        texts = [f"Pred: {pred_cnt:.3f}"]

    full = _to_pil(np.concatenate(panels, axis=1))
    draw = ImageDraw.Draw(full)
    for i, t in enumerate(texts):
        draw.text((full.width - 150, full.height - 50 - 20 * i), t, (255, 255, 255))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    full.save(path)


def save_exemplar_strip(path: str, boxes: np.ndarray) -> None:
    """Concatenate exemplar crops horizontally
    (reference: FSC_test_cross(few-shot).py:423-425)."""
    if boxes.shape[0] == 0:
        return
    strip = np.concatenate(list(boxes), axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _to_pil(strip).save(path)


def frames_to_video(frame_dir: str, out_path: str, fps: float = 30.0) -> bool:
    """Stitch a directory of frames (sorted by name) into an mp4v video;
    False when it holds none (reference: util/misc.py:623-633 frames2vid)."""
    import cv2

    frames = sorted(f for f in os.listdir(frame_dir)
                    if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not frames:
        return False
    first = cv2.imread(os.path.join(frame_dir, frames[0]))
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        img = cv2.imread(os.path.join(frame_dir, f))
        if img.shape[:2] != (h, w):
            img = cv2.resize(img, (w, h))
        vw.write(img)
    vw.release()
    return True


def write_zeroshot_annotations(dir_path: str, h: int = 960, w: int = 1280) -> None:
    """FSC147-format metadata for a folder of images without annotations:
    <dir>/images/* -> <dir>/annotations.json (no points or boxes per image)
    and <dir>/split.json ({"test": [...]}), so that the zero-shot test CLI
    runs on it (reference: util/misc.py:470-489, whose hand-written JSON
    has trailing commas; this one is valid JSON)."""
    imdir = os.path.join(dir_path, "images")
    names = sorted(f for f in os.listdir(imdir) if os.path.isfile(os.path.join(imdir, f)))
    anno = {n: {"H": h, "W": w, "box_examples_coordinates": [], "points": []} for n in names}
    with open(os.path.join(dir_path, "annotations.json"), "w", encoding="utf-8") as f:
        json.dump(anno, f, indent=2)
    with open(os.path.join(dir_path, "split.json"), "w", encoding="utf-8") as f:
        json.dump({"test": names}, f, indent=2)


def write_annotations_gt(old_annotations: str, new_annotations: str, gt_csv: str) -> None:
    """Merge a VIA-export CSV of dot annotations (filename and
    region_shape_attributes JSON with cx/cy) into an FSC147-format
    annotations file (reference: util/misc.py:492-506)."""
    with open(old_annotations, encoding="utf-8") as f:
        anno = json.load(f)
    points: dict = {}
    with open(gt_csv, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            shape = json.loads(row["region_shape_attributes"])
            if "cx" in shape and "cy" in shape:
                points.setdefault(row["filename"], []).append([shape["cx"], shape["cy"]])
    for filename, pts in points.items():
        anno[filename]["points"] = pts
    with open(new_annotations, "w", encoding="utf-8") as f:
        json.dump(anno, f, indent=4)


def write_predicted_points(path: str, name: str, density: np.ndarray,
                           threshold: float = 0.1) -> None:
    """The predicted object locations of one image (the density's local
    maxima over 5x5 above ``threshold``) and its count, as JSON."""
    from scipy import ndimage as ndi

    maxima = (density == ndi.maximum_filter(density, size=5)) & (density > threshold)
    ys, xs = np.nonzero(maxima)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"image": name, "count": float(density.sum() / 60.0),
                   "points_xy": [[int(x), int(y)] for x, y in zip(xs, ys)]}, f)


def save_results(
    output_dir: str,
    names: List[str],
    preds: List[float],
    gts: List[float],
) -> None:
    """results.csv (columns time, name, prediction; the JAX package's
    pandas output) and, where matplotlib imports, the error scatter plot
    test_stat.png (reference: FSC_test_cross(few-shot).py:447-453)."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "results.csv"), "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["time", "name", "prediction"])
        for k, (name, p) in enumerate(zip(names, preds), 1):
            writer.writerow([k, name, round(p)])
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.scatter(gts, [abs(p - g) for p, g in zip(preds, gts)])
    plt.xlabel("Ground Truth")
    plt.ylabel("Error")
    plt.savefig(os.path.join(output_dir, "test_stat.png"))
    plt.close()
