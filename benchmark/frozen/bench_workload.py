"""A frozen copy of ``countr_tpu_torch/bench.py``'s ``workload()`` (the
counting benchmark's geometry, itself the JAX package's ``bench.py``
geometry), with its constants read from a traffic file instead of the
module: images of height 384 at FSC147-like widths (multiples of 16),
uint8 pixels, 3 exemplar rects each; every ``tiny_every``-th image
carries tiny (<10x10) rects and so runs 3x3 grid mode (reference:
FSC_test_cross(few-shot).py:264-284). Pixel content is uniform noise, as
there: throughput does not depend on it."""

from __future__ import annotations

import numpy as np


def workload(rng: np.random.Generator, n_images: int, widths, plain_rects, tiny_rects,
             tiny_every: int, height: int = 384, shot: int = 3):
    """(images, rects) for ``n_images`` images: image i is
    ``widths[i % len(widths)]`` wide, and has ``tiny_rects`` when
    ``i % tiny_every == tiny_every - 1`` (0: never), else ``plain_rects``
    (none at zero shots)."""
    images = [rng.integers(0, 256, (height, widths[i % len(widths)], 3), dtype=np.uint8)
              for i in range(n_images)]
    rects = []
    for i in range(n_images):
        if shot == 0:
            rects.append([])
        elif tiny_every and i % tiny_every == tiny_every - 1:
            rects.append([list(r) for r in tiny_rects])
        else:
            rects.append([list(r) for r in plain_rects])
    return images, rects
