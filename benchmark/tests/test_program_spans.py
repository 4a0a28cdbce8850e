"""CPU tests of ``lib/program_spans.py`` and the five readers of the
device's idle time under the program's spans, on synthetic trace
summaries and span logs (the summary's clock in Unix-epoch seconds, or
in seconds since the trace's start as torch 2.11's summaries read), and
on a real CPU trace of program spans.

    python -m pytest benchmark/tests/test_program_spans.py -q
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import common  # noqa: E402
from benchmark.lib.program_spans import (  # noqa: E402
    COUNT_ANCHOR, TRAIN_ANCHOR, clock_offset, idle_by_span, idle_share_under, innermost,
)
from benchmark.lib.readers import idle_share  # noqa: E402

READERS = {"count.idle_plan": ["count.plan_sets", "count.plan_set"],
           "count.idle_launch": ["count.upload", "count.exemplars", "count.forward",
                                 "count.stitch", "count.finalize", "graph.replay",
                                 "graph.check", "graph.capture"],
           "count.idle_collect": ["count.collect", "count.batch"],
           "train.idle_step": ["train.step", "graph.replay", "train.log"],
           "train.idle_data": ["data.next"]}
T0 = 1.79e9  # a Unix-epoch second, as the program's clock reads
BASES = {"epoch": T0, "since_start": 0.0}  # the summary's clock


def reader(name):
    return common.load_module(common.BENCH / "metrics" / f"{name}.py")


def anchor_of(name):
    return COUNT_ANCHOR if name.startswith("count.") else TRAIN_ANCHOR


def layer(device, window_s, bench_spans=(), base=T0):
    busy = sum(e - s for s, e in device)
    return {"trace": {"window_s": window_s, "busy_s": busy,
                      "device": [("k", base + s, base + e) for s, e in device],
                      "spans": [(n, base + s, base + e) for n, s, e in bench_spans]}}


def spans(*items):
    return [(n, T0 + s, T0 + e) for n, s, e in items]


def records(items, thread=None):
    """SpanRecords of (name, start_s, end_s) after T0, on ``thread``."""
    from countr_tpu_torch.utils.profiling import SpanRecord

    thread = threading.get_ident() if thread is None else thread
    return [SpanRecord(k, n, round((T0 + s) * 1e9), round((T0 + e) * 1e9), None, k, thread)
            for k, (n, s, e) in enumerate(items)]


def test_innermost_pieces():
    got = innermost(spans(("root", 0, 10), ("a", 1, 4), ("b", 4, 6), ("leaf", 2, 3)))
    want = [("root", 0, 1), ("a", 1, 2), ("leaf", 2, 3), ("a", 3, 4), ("b", 4, 6),
            ("root", 6, 10)]
    assert [(n, round(a - T0, 6), round(b - T0, 6)) for n, a, b in got] == want


def test_a_gap_over_two_siblings_is_split_by_overlap():
    lay = layer([(0, 2), (6, 10)], 10)  # one gap, [2, 6)
    by, out = idle_by_span(lay, COUNT_ANCHOR, spans(("root", 0, 10), ("a", 1, 3), ("b", 3, 7)))
    assert by == pytest.approx({"a": 1.0, "b": 3.0})
    assert out == pytest.approx(0.0, abs=1e-6)


def test_the_innermost_span_takes_the_gap():
    lay = layer([(0, 1), (5, 10)], 10)  # gap [1, 5)
    by, out = idle_by_span(lay, COUNT_ANCHOR, spans(
        ("count.batch", 0, 10), ("count.forward", 2, 4), ("graph.replay", 3, 4)))
    assert by == pytest.approx({"count.batch": 2.0, "count.forward": 1.0, "graph.replay": 1.0})
    assert idle_share_under(lay, COUNT_ANCHOR, ("count.collect", "count.batch"),
                            spans=spans(("count.batch", 0, 10))) == pytest.approx(40.0)


def test_idle_outside_every_span_is_the_remainder():
    lay = layer([(2, 3), (7, 8)], 10)  # gaps [0, 2), [3, 7), [8, 10)
    by, out = idle_by_span(lay, COUNT_ANCHOR, spans(("a", 3.5, 5)))
    assert by == pytest.approx({"a": 1.5})
    assert out == pytest.approx(2 + 2.5 + 2)
    assert sum(by.values()) + out == pytest.approx(lay["trace"]["window_s"] - 2)


def test_the_stretch_starts_at_its_first_device_interval_or_bench_span():
    lay = layer([(1, 2)], 4, bench_spans=[("count_batch", 0.5, 3)])  # stretch [0.5, 4.5)
    by, out = idle_by_span(lay, COUNT_ANCHOR, spans(("count.batch", 0.0, 4.5)))
    assert by["count.batch"] == pytest.approx(3.0)  # [0.5, 1) and [2, 4.5)
    assert out == pytest.approx(0.0, abs=1e-6)


def test_clock_offset_nests_each_inner_span_in_its_outer_one():
    rng = np.random.default_rng(5)
    starts = np.cumsum(rng.uniform(0.05, 0.15, 30))
    lens = rng.uniform(0.02, 0.1, 30)
    outer = [("count_batch", s, s + n) for s, n in zip(starts, lens)]
    d = 1.79e9 + 0.123456
    inner = [("count.batch", s + d + 20e-6, s + n + d - 10e-6) for s, n in zip(starts, lens)]
    assert clock_offset(outer, inner) == pytest.approx(d + 5e-6, abs=1e-6)
    # one inner span too many (recorded before the outer ones): the shift finds the pairing
    assert clock_offset(outer, [("count.batch", d - 5, d - 4.99)] + inner) == pytest.approx(
        d + 5e-6, abs=1e-6)
    # a program span that outlasts its benchmark span cannot nest in it
    assert clock_offset(outer[:1], [("count.batch", d, d + 1.0)]) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_none_without_a_span_to_read(monkeypatch, name):
    from countr_tpu_torch.utils import profiling

    mod = reader(name)
    assert mod.read({}) is None
    outer, inner, _ = anchor_of(name)
    lay = layer([(0, 1)], 2, bench_spans=[(outer, 0.1, 0.9)])
    monkeypatch.setattr(profiling, "span_log", lambda: [])
    assert mod.read(lay) is None
    # no span of the anchor: nothing puts the program's clock on the trace's
    monkeypatch.setattr(profiling, "span_log", lambda: records([("other", 0.2, 0.3)]))
    assert mod.read(lay) is None
    # an anchor span that outlasts the benchmark's span around it: no pairing
    monkeypatch.setattr(profiling, "span_log", lambda: records([(inner, 0.0, 1.0)]))
    assert mod.read(lay) is None
    # a program without span_log (a checkout before its spans): no number
    monkeypatch.delattr(profiling, "span_log")
    assert mod.read(lay) is None


@pytest.mark.parametrize("clock", sorted(BASES))
@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_its_own_spans(monkeypatch, name, clock):
    from countr_tpu_torch.utils import profiling

    outer, inner, _ = anchor_of(name)
    # the summary: the device busy [0, 1) and [18, 19), the benchmark's span
    # [0.5, 19.5); the program's spans at T0 + t (the trace started at T0)
    lay = layer([(0, 1), (18, 19)], 20, bench_spans=[(outer, 0.5, 19.5)], base=BASES[clock])
    items = [(inner, 0.6, 19.4)]
    items += [(n, 2 + k, 3 + k) for k, n in enumerate(READERS[name]) if n != inner]
    logged = records(items) + records([("elsewhere", 0, 20)], thread=threading.get_ident() + 1)
    monkeypatch.setattr(profiling, "span_log", lambda: logged)
    own = len(items) - 1.0  # a second under each of the reader's spans but the anchor
    # the anchor's own idle: the gaps [1, 18) and [19, 19.4) less the others'
    under_inner = (17.4 - own) if inner in READERS[name] else 0.0
    assert reader(name).read(lay) == pytest.approx(100.0 * (own + under_inner) / 20, abs=1e-3)


def test_a_drifting_device_clock_is_retimed_by_the_synced_anchor():
    # a call each 0.1 s: the host plans [2, 14) ms, launches [14, 30), waits
    # in the read-back [30, 95); the device works [16, 94); the trace's
    # device clock runs 3% fast after 0.3 s, as torch 2.11's traces can
    host, device, n = [], [], 40

    def drift(t):
        return 0.03 * max(0.0, t - 0.3)

    for k in range(n):
        b = 0.1 * k
        host += [("count.batch", b + 0.001, b + 0.0951), ("count.plan_set", b + 0.002, b + 0.014),
                 ("count.forward", b + 0.014, b + 0.03), ("count.collect", b + 0.03, b + 0.095)]
        device.append((b + 0.016 + drift(b + 0.016), b + 0.094 + drift(b + 0.094)))
    window = 0.1 * n
    lay = layer(device, window, bench_spans=[("count_batch", 0.1 * k, 0.1 * k + 0.096)
                                             for k in range(n)])
    by, out = idle_by_span(lay, COUNT_ANCHOR, spans(*host))
    # the truth: plan_set 12 ms a call, forward 2, collect 1 (none after the last)
    assert by["count.plan_set"] == pytest.approx(n * 0.012, rel=0.02)
    assert by["count.forward"] == pytest.approx(n * 0.002, rel=0.05)
    assert by["count.collect"] == pytest.approx((n - 1) * 0.001, rel=0.05)
    assert sum(by.values()) + out == pytest.approx(window - n * 0.078, abs=1e-3)
    assert idle_share(lay) < 100 * (window - n * 0.078) / window  # the drift's longer work
    # on the trace's own times the late device's gaps fall under the launch
    # and the read-back
    plain = idle_by_span(lay, ("count_batch", "count.batch", False), spans(*host))[0]
    assert plain["count.forward"] > 1.5 * n * 0.002


def test_the_readers_sum_never_exceeds_the_idle_share(monkeypatch):
    from countr_tpu_torch.utils import profiling

    rng = np.random.default_rng(7)
    names = sorted({n for v in READERS.values() for n in v} | {"data.stage", "other"})
    for trial in range(40):
        window = 4.0
        cuts = np.sort(rng.uniform(0, window, 2 * rng.integers(1, 60)))
        device = [(float(a), float(b)) for a, b in cuts.reshape(-1, 2)]
        base = (0.0, T0)[trial % 2]
        lay = layer(device, window, base=base,
                    bench_spans=[("count_batch", 0.0, window), ("loader_next", 0.0, window)])
        # one call: no second pin moves the device's times (``retime``), so
        # the readers read the trace's own gaps
        items = [("count.batch", 0.001, window - 0.001), ("data.next", 0.002, window - 0.002)]

        def nest(lo, hi, depth):
            t = lo
            while t < hi and depth < 4:
                a = t + rng.uniform(0, (hi - t) / 2)
                b = a + rng.uniform(0, hi - a)
                items.append((str(rng.choice(names)), a, b))
                nest(a, b, depth + 1)
                t = b + rng.uniform(0, 0.3)

        nest(-0.5, window + 0.5, 0)
        logged = records(items)
        monkeypatch.setattr(profiling, "span_log", lambda: logged)
        for cell in ("count.", "train."):  # graph.* is read in each cell's own way
            total = sum(reader(n).read(lay) for n in READERS if n.startswith(cell))
            assert total <= idle_share(lay) + 1e-6, (trial, cell)
        by, out = idle_by_span(lay, COUNT_ANCHOR)
        assert 100 * (sum(by.values()) + out) / window == pytest.approx(idle_share(lay), abs=1e-4)


def test_a_cpu_trace_of_program_spans_is_read():
    from benchmark.lib.trace import Profile, span
    from countr_tpu_torch.utils import profiling

    profiling.clear_span_log()
    with Profile() as prof:
        for _ in range(3):
            with span("count_batch"):
                with profiling.span("count.batch"):
                    with profiling.span("count.plan_sets"):
                        sum(range(20000))
                    with profiling.span("count.collect"):
                        sum(range(20000))
    lay = {"trace": prof.summary}
    # no device on the CPU: the whole stretch is idle, and the spans take it
    plan, collect = reader("count.idle_plan").read(lay), reader("count.idle_collect").read(lay)
    assert plan > 0 and collect > 0 and plan + collect <= 100.0 + 1e-6
    got = idle_by_span(lay, COUNT_ANCHOR)
    assert got is not None and set(got[0]) == {"count.batch", "count.plan_sets", "count.collect"}
    assert reader("train.idle_data").read(lay) is None  # no loader_next to anchor on
    profiling.clear_span_log()
