"""Single-image / directory counting demo on the port (counterpart of
``countr_tpu/cli/demo.py``; reference: demo.py few-shot, demo_zero.py
zero-shot): preprocesses like the test pipeline, counts with
``count_batch``, prints the count and latency, writes an overlay panel.

Usage:
  # zero-shot over a directory
  python -m countr_tpu_torch.cli.demo --input_path imgs/ --resume weights.pth
  # few-shot with exemplar boxes (x1,y1,x2,y2 in original pixels)
  python -m countr_tpu_torch.cli.demo --input_path img.jpg --resume weights.pth \\
      --boxes "10,20,60,80;100,120,150,170;200,210,250,260"
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List

from countr_tpu_torch.cli import common


def get_args(argv=None):
    p = argparse.ArgumentParser("counting demo")
    common.add_model_args(p, default_model="mae_vit_base6_patch16")
    p.add_argument("--input_path", required=True, type=str,
                   help="image file or directory")
    p.add_argument("--output_path", default="./demo_out", type=str)
    p.add_argument("--boxes", default="", type=str,
                   help="exemplar boxes 'x1,y1,x2,y2;...' in original "
                        "image pixels (absent = zero-shot)")
    p.add_argument("--batch_windows", default=16, type=int)
    p.add_argument("--no_normalization", action="store_true")
    return p.parse_args(argv)


def parse_boxes(spec: str) -> List[List[float]]:
    if not spec:
        return []
    out = []
    for part in spec.split(";"):
        x1, y1, x2, y2 = (float(v) for v in part.split(","))
        out.append([x1, y1, x2, y2])
    return out


def main(args, engine=None):
    """Count every image of ``--input_path``; returns [(file name,
    CountResult)]. ``engine``: the CountingEngine to count with
    (default: built from args)."""
    from PIL import Image

    from countr_tpu_torch.data import transforms as T
    from countr_tpu_torch.utils import viz

    if engine is None:
        engine = common.build_engine(args, normalization=not args.no_normalization)
    os.makedirs(args.output_path, exist_ok=True)

    if os.path.isdir(args.input_path):
        files = sorted(
            os.path.join(args.input_path, f)
            for f in os.listdir(args.input_path)
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        )
    else:
        files = [args.input_path]

    user_boxes = parse_boxes(args.boxes)
    out = []
    for path in files:
        image, boxes, rects = T.prepare_raw(Image.open(path), user_boxes)

        t0 = time.perf_counter()
        res = engine.count_batch([image], [boxes], [rects], shot_num=len(rects))[0]
        dt = time.perf_counter() - t0
        name = os.path.basename(path)
        print(f"{name}: count={res.count:.2f}  ({dt:.3f}s, "
              f"{res.n_windows} windows, grid={res.grid_mode})", flush=True)
        viz.save_prediction_panel(
            os.path.join(args.output_path, f"{os.path.splitext(name)[0]}__{round(res.count)}.png"),
            image, res.density, None, rects, res.count,
        )
        out.append((name, res))
    return out


def _entry():
    main(get_args())


if __name__ == "__main__":
    _entry()
