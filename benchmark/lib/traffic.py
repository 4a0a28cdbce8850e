"""The one generator of the benchmark's traffic: it reads a traffic
file's parameters and draws the run's inputs from its seed. Every seed
gets the same multiset of sizes and shot counts, in an order (and with
pixels) of its own, so that seeds change which
inputs come when, not how much work a run holds."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark.frozen.bench_workload import workload
from benchmark.lib.common import seed_stream

FIXED = 0  # salt of the draws every seed shares (the multiset)


def count_traffic(t: Dict, seed: int) -> Dict:
    """Offline counting: a pool of images (``frozen/bench_workload``: the
    widths and grid images fixed by position, the pixels drawn from the
    seed) and ``n_calls`` calls of ``batch_images`` pool indices. Which
    images ride one call is a fixed draw, each cycle through the pool a
    partition of its own; the seed permutes the order of the calls."""
    images, rects = workload(seed_stream(seed, 1), t["pool_images"], t["widths"],
                             t["plain_rects"], t["tiny_rects"], t["tiny_every"], t["height"],
                             t["shot"])
    b, n = t["batch_images"], t["pool_images"]
    if n % b:
        raise ValueError("pool_images must be a multiple of batch_images")
    calls: List[List[int]] = []
    parts = seed_stream(FIXED, 2)
    while len(calls) < t["n_calls"]:
        perm = parts.permutation(n)
        calls.extend([sorted(perm[i:i + b].tolist()) for i in range(0, n, b)])
    calls = calls[:t["n_calls"]]
    order = seed_stream(seed, 2).permutation(len(calls))
    return {"images": images, "rects": rects, "calls": [calls[i] for i in order]}
