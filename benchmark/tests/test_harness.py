"""CPU tests of the benchmark's harness: the traffic, the statistics, the
trace's arithmetic, the work functions, the files found by name, and
``run.py`` without a card.

    python -m pytest benchmark/tests -q
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import common, traffic  # noqa: E402
from benchmark.lib.trace import idle_gaps, label_gaps, summarize, union_seconds  # noqa: E402

SPEC = common.load_json(ROOT / "BENCHMARK.json")
BIG_SEED = 2**31 + 977


def _traffic(name):
    return common.load_json(common.BENCH / "traffic" / f"{name}.json")


def test_count_traffic_same_seed_same_inputs():
    t = dict(_traffic("fsc147_fewshot"), pool_images=16, n_calls=8)
    a, b = traffic.count_traffic(t, BIG_SEED), traffic.count_traffic(t, BIG_SEED)
    assert a["calls"] == b["calls"] and a["rects"] == b["rects"]
    assert all(np.array_equal(x, y) for x, y in zip(a["images"], b["images"]))


def test_count_traffic_seeds_differ_in_order_not_work():
    t = dict(_traffic("fsc147_fewshot"), pool_images=32, n_calls=8)
    a, b = traffic.count_traffic(t, 1), traffic.count_traffic(t, BIG_SEED)
    assert a["calls"] != b["calls"]
    assert not np.array_equal(a["images"][0], b["images"][0])
    # the same multiset of widths and of grid images
    assert sorted(im.shape[1] for im in a["images"]) == sorted(im.shape[1] for im in b["images"])
    assert sorted(map(str, a["rects"])) == sorted(map(str, b["rects"]))
    # the same calls (which images ride together), in another order
    assert sorted(map(tuple, a["calls"])) == sorted(map(tuple, b["calls"]))
    # each call holds distinct images
    assert all(len(set(c)) == len(c) == t["batch_images"] for c in a["calls"])


def test_quantiles_are_the_statistics_modules():
    assert common.quantiles([1, 2, 3, 4, 5]) == tuple(__import__("statistics").quantiles(
        [1, 2, 3, 4, 5], n=4))


def test_interval_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.5, 2.7)]
    assert union_seconds(iv) == pytest.approx(2.5)
    gaps = idle_gaps(iv, 0.0, 4.0)
    assert gaps == [(1.5, 2.0), (3.0, 4.0)]
    lab = label_gaps(gaps, [("count_batch", 1.0, 2.5), ("outer", 0.0, 5.0)])
    assert lab == {"count_batch": pytest.approx(0.5), "outer": pytest.approx(1.0)}
    s = summarize([("k1", True, 0.0, 1.0), ("k2", True, 0.5, 1.5), ("bench.x", False, 0.0, 2.0)],
                  2.0)
    assert s["busy_s"] == pytest.approx(1.5)
    assert s["breakdown"]["device_ops"][0][0] == "k1"


def test_flop_functions_against_hand_counts():
    from benchmark.work.kernels import b2, b3, b4
    from benchmark.work.models import countr, mae, vit

    # ViT-B/16 forward at 576 tokens: 12 blocks of 24*N*C^2 + 4*N^2*C
    n, c = 576, 768
    hand = 12 * (24 * n * c * c + 4 * n * n * c)
    assert 12 * vit.block(n, c, 4 * c) == hand
    assert hand == pytest.approx(110.08e9, rel=1e-3)
    cfg = common.load_json(common.BENCH / "configs" / "countr_base6.json")
    head = sum(2 * s * s * 9 * ci * 256 for s, ci in ((24, 512), (48, 256), (96, 256), (192, 256)))
    assert head == pytest.approx(58.4e9, rel=1e-2)
    assert countr.window(cfg, 3) == pytest.approx(199.1e9, rel=1e-2)
    mcfg = common.load_json(common.BENCH / "configs" / "mae_base.json")
    assert mae.forward(mcfg) == pytest.approx(87.8e9, rel=1e-2)
    assert mae.train_sample(mcfg) == 3 * mae.forward(mcfg)
    assert b3.flops(8, 576, 512) == 4 * 8 * 576 * 576 * 512
    assert b4.flops(8, 576, 512) == 10 * 8 * 576 * 576 * 512
    assert b2.flops(16, 576, 768) == 8 * 16 * 576 * 768 * 768 + 4 * 16 * 576 * 576 * 768


def test_every_file_found_by_name():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        cfg = common.load_json(ROOT / configs[w["config"]]["file"])
        assert cfg["name"] == w["config"]
        t = _traffic(w["traffic"])
        assert (common.BENCH / "drivers" / f"{t['driver']}.py").exists()
        # an exact comparison (a count of faults) has the limit 0
        assert set(t["limits"]) and all(v >= 0 for v in t["limits"].values())
    for m in SPEC["per_layer"]:
        mod = common.load_module(common.BENCH / "metrics" / f"{m['name']}.py")
        assert mod.read({}) is None  # nothing to read: no number
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("benchmark/")


def test_run_exits_nonzero_without_a_card():
    w = SPEC["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, str(common.BENCH / "run.py"), "--workload", w, "--seed", str(BIG_SEED),
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""  # no result line
