"""The B1bwd roofline readers (``metrics/b1bwd_roofline.*.py``) on a
recorded layer: the plan's B1 launches read as B1bwd's against the
``_ln_bwd`` kernels' device seconds; nothing read where the program has
no B1bwd counter (a parent without the kernel), where it disagrees with
the plan, or where the trace holds no backward kernel; the forward's B1
reader keeps timing ``_ln_fwd`` alone."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.lib import common, peaks  # noqa: E402
from benchmark.work.kernels import b1, b1bwd  # noqa: E402

PLAN = {(11648, 1280): 65, (23328, 512): 17}


def layer(counted, device):
    return {"trace": {"device": device, "window_s": 1.0, "busy_s": 0.5},
            "launches": {"B1": PLAN, "B3": {(32, 364, 1280): 32}},
            "launches_counted": counted}


def read(name, lay):
    return common.load_module(common.BENCH / "metrics" / f"{name}.py").read(lay)


@pytest.mark.parametrize("name", ["b1bwd_roofline.train", "b1bwd_roofline.pretrain_huge"])
def test_reads_the_backward_kernels(name):
    least = sum(n * peaks.least_seconds(b1bwd.flops(*s), b1bwd.nbytes(*s)) for s, n in PLAN.items())
    device = [("_ln_bwd_0d1d", 0.0, 1.5 * least), ("_ln_bwd_cols_0d1d", 1.5 * least, 2 * least),
              ("_ln_fwd_0d1d", 1.0, 1.5)]
    assert read(name, layer({"B1": 82, "B1bwd": 82}, device)) == pytest.approx(50.0)
    assert read(name, layer({"B1": 82}, device)) is None  # no B1bwd counter
    assert read(name, layer({"B1": 82, "B1bwd": 81}, device)) is None
    assert read(name, layer({"B1": 82, "B1bwd": 82}, device[2:])) is None


def test_forward_reader_leaves_the_backward_out():
    assert not any(k in "_ln_bwd_0d1d" or k in "_ln_bwd_cols" for k in b1.TRACE_NAMES)
    assert b1bwd.nbytes(4, 8) == 6 * 4 * 8 + 8 * 8
