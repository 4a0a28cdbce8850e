"""The program's spans (``countr_tpu_torch/utils/profiling.py span``).

On the CPU: with no profiler running ``span`` is one shared no-op that
reads no clock and opens no profiler range; under
``torch.profiler.profile`` spans nest by thread (parent, call id), their
times agree with the profiler's own ``countr.<name>`` events within 50
us (the shared clock), and ``trace``'s ``trace.json`` carries them;
``count_batch`` of a tiny CounTR yields its span tree, one
``count.forward`` and one ``count.stitch`` per ``chunk_plan`` chunk;
an eager pretrain step yields ``train.step``; ``device_prefetch`` yields
``data.next`` on the consumer's thread and ``data.stage`` on its
producer's. On the card (marker ``cuda``; no JAX, so it runs there with
``python -m pytest --noconftest tests/test_torch_tracing.py``): a
``torch.cuda._sleep`` kernel launched inside a span runs, in the device
trace, between the span's start and its end, and the span has no copy
on the device's track; ``count_batch`` of a tiny bf16 CounTR spans each
chunk's ``graph.check`` and ``graph.replay`` inside its
``count.forward``, and no span is copied onto the device's track.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from countr_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)  # six test workers share the cores

TOL_NS = 50_000  # a span's stamps against the profiler's event of it
TINY = dict(img_size=384, patch_size=16, embed_dim=64, depth=2, num_heads=4,
            decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4, head_width=32)


@pytest.fixture(autouse=True)
def empty_log():
    tprof.clear_span_log()
    yield
    tprof.clear_span_log()


def _events(prof, host: bool = True) -> dict:
    """name -> [(start_ns, end_ns)] of the trace's host (or device) events."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ("CPU" in str(ev.device_type())) == host:
            out.setdefault(ev.name(), []).append((ev.start_ns(), ev.end_ns()))
    return out


def _by_name(records) -> dict:
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_span_without_a_profiler_is_a_shared_noop(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("no clock reading and no profiler range while tracing is off")

    monkeypatch.setattr(tprof.time, "time_ns", boom)
    monkeypatch.setattr(tprof, "_RecordFunctionFast", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = tprof.span("count.batch"), tprof.span("train.step")
    assert a is b is tprof.annotate("anything")
    with a, tprof.span("inner"):
        pass
    assert tprof.span_log() == [] and tprof.spans_dropped() == 0


def test_nested_spans_on_two_threads_get_parents_and_calls():
    both_open = threading.Barrier(2, timeout=30)

    def work(tag):
        with tprof.span(f"{tag}.outer"):
            with tprof.span(f"{tag}.mid"):
                with tprof.span(f"{tag}.leaf"):
                    both_open.wait()
            with tprof.span(f"{tag}.mid2"):
                pass

    with profile(activities=[ProfilerActivity.CPU]):
        other = threading.Thread(target=work, args=("b",))
        other.start()
        work("a")
        other.join(timeout=30)
        with tprof.span("a.second_call"):
            pass
    assert not other.is_alive()
    recs = _by_name(tprof.span_log())
    assert len(recs) == 9 and all(len(v) == 1 for v in recs.values())
    r = {k: v[0] for k, v in recs.items()}
    for tag in "ab":
        outer = r[f"{tag}.outer"]
        assert outer.parent is None and outer.call == outer.id
        assert r[f"{tag}.mid"].parent == outer.id and r[f"{tag}.mid2"].parent == outer.id
        assert r[f"{tag}.leaf"].parent == r[f"{tag}.mid"].id
        members = [r[f"{tag}.{n}"] for n in ("outer", "mid", "leaf", "mid2")]
        assert {m.call for m in members} == {outer.id}
        assert len({m.thread for m in members}) == 1
        for m in members[1:]:
            assert outer.start_ns <= m.start_ns <= m.end_ns <= outer.end_ns
    assert r["a.outer"].thread != r["b.outer"].thread
    assert r["a.second_call"].call == r["a.second_call"].id != r["a.outer"].id
    # the leaves were open at once, on their two threads
    assert max(r["a.leaf"].start_ns, r["b.leaf"].start_ns) < min(r["a.leaf"].end_ns,
                                                                 r["b.leaf"].end_ns)


def test_span_times_match_the_profilers_events():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(8):
            with tprof.span(f"clock.{k}"):
                with tprof.span(f"clock.{k}.inner"):
                    torch.ones(64).sum()
                torch.ones(64).cumsum(0)
    events = _events(prof)
    recs = tprof.span_log()
    assert len(recs) == 16
    for r in recs:
        (start, end), = events[tprof.SPAN_PREFIX + r.name]
        assert abs(start - r.start_ns) <= TOL_NS, (r.name, start - r.start_ns)
        assert abs(end - r.end_ns) <= TOL_NS, (r.name, end - r.end_ns)


def test_trace_json_carries_the_spans(tmp_path):
    with tprof.trace(str(tmp_path)):
        with tprof.span("count.batch"):
            torch.ones(4).sum()
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())
             ["traceEvents"]}
    assert "countr.count.batch" in names


def test_count_batch_yields_its_span_tree():
    from countr_tpu_torch.engine.device_pipeline import chunk_plan
    from countr_tpu_torch.engine.inference import CountingEngine
    from countr_tpu_torch.models import build_countr

    model = build_countr(device="cpu", **TINY)
    engine = CountingEngine(model, batch_windows=4, images_bucket=12, device="cpu")
    rng = np.random.default_rng(3)
    widths = (384, 512, 640, 448, 600)
    imgs = [rng.integers(0, 256, (384, w, 3), dtype=np.uint8) for w in widths]
    plain = [(40, 40, 110, 120), (150, 60, 230, 140), (250, 200, 330, 300)]
    tiny = [(5, 5, 12, 12), (50, 50, 120, 130), (10, 20, 60, 80)]
    rects = [plain, plain, plain, tiny, plain]
    boxes = [rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32) for _ in imgs]
    sets = engine.plan_batch_sets(imgs, rects)
    assert len(sets) >= 2  # the grid image's 9 rows overflow one set of 12
    chunks = sum(len(chunk_plan(sum(engine.windows_per_image(imgs[i].shape[1], rects[i])[1]
                                    for i in s), 4)) for s in sets)
    with profile(activities=[ProfilerActivity.CPU]):
        engine.count_batch(imgs, boxes, rects, shot_num=3, return_density=False)
    recs = tprof.span_log()
    names = _by_name(recs)
    (root,) = names["count.batch"]
    assert root.parent is None
    assert {k: len(v) for k, v in names.items()} == {
        "count.batch": 1, "count.plan_sets": 1, "count.plan_set": len(sets),
        "count.upload": 2 * len(sets), "count.exemplars": len(sets),
        "count.forward": chunks, "count.stitch": chunks, "count.finalize": len(sets),
        "count.collect": len(sets)}
    for r in recs:  # on the CPU the forward is eager: no graph span
        assert r.call == root.id and r.thread == root.thread
        if r is not root:
            assert r.parent == root.id and root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
    # in call order: the plan, then each set's assembly, upload and exemplars,
    # its chunks, its finalize; then the reads
    order = [r.name for r in sorted(recs, key=lambda r: r.start_ns) if r is not root]
    assert order[0] == "count.plan_sets"
    assert order[1:4] == ["count.plan_set", "count.upload", "count.exemplars"]
    assert order[-len(sets):] == ["count.collect"] * len(sets)


def test_pretrain_step_yields_train_step():
    from countr_tpu_torch.config import TrainConfig
    from countr_tpu_torch.engine import train as ttrain
    from countr_tpu_torch.models import build_mae

    tiny = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4)
    model = build_mae(device="cpu", dtype="fp32", **tiny)
    cfg = TrainConfig(batch_size=2, epochs=2, warmup_epochs=0, lr=1e-3, weight_decay=0.05)
    state = ttrain.init_train_state(model, cfg, steps_per_epoch=2, world_batch=2)
    step = ttrain.make_pretrain_step(state, cfg)
    imgs = torch.rand((2, 64, 64, 3))
    step(imgs)
    with profile(activities=[ProfilerActivity.CPU]):
        step(imgs)
        step(imgs)
    recs = tprof.span_log()
    assert [r.name for r in recs] == ["train.step", "train.step"]
    assert all(r.parent is None and r.call == r.id for r in recs)
    assert recs[0].end_ns <= recs[1].start_ns


def test_device_prefetch_spans_the_wait_and_the_staging():
    from countr_tpu_torch.data.loader import device_prefetch

    batches = [{"image": np.full((2, 4), k, np.float32), "name": k} for k in range(5)]
    with profile(activities=[ProfilerActivity.CPU]):
        got = [b["name"] for b in device_prefetch(iter(batches), "cpu")]
    assert got == list(range(5))
    names = _by_name(tprof.span_log())
    assert len(names["data.stage"]) == 5
    assert len(names["data.next"]) == 6  # the last one takes the end
    consumer = {r.thread for r in names["data.next"]}
    producer = {r.thread for r in names["data.stage"]}
    assert consumer == {threading.get_ident()} and len(producer) == 1
    assert producer != consumer
    assert all(r.parent is None for r in names["data.next"] + names["data.stage"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the device trace's clock)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_kernel_runs_inside_its_span_on_the_device_trace(cuda_device):
    cycles = 20_000_000  # ~10 ms at the H100's clocks
    torch.cuda._sleep(1000)  # the first launch loads the module
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(3):
            with tprof.span(f"sleep.{k}"):
                torch.cuda._sleep(cycles)
                torch.cuda.synchronize()
    recs = tprof.span_log()
    kernels = sorted((ev.start_ns(), ev.end_ns()) for ev in prof.profiler.kineto_results.events()
                     if "CPU" not in str(ev.device_type()) and "spin_kernel" in ev.name())
    assert len(recs) == len(kernels) == 3
    host = _events(prof)
    # no copy of a span on the device's track, which a reader of device
    # intervals would count as work
    assert not any(n.startswith(tprof.SPAN_PREFIX) for n in _events(prof, host=False))
    for r, (ks, ke) in zip(recs, kernels):
        (hs, he), = host[tprof.SPAN_PREFIX + r.name]
        print(f"{r.name}: kernel {(ke - ks) / 1e3:.1f} us; kernel start - span start "
              f"{(ks - r.start_ns) / 1e3:.1f} us; span end - kernel end "
              f"{(r.end_ns - ke) / 1e3:.1f} us; profiler event - span: start "
              f"{(hs - r.start_ns) / 1e3:.1f} us, end {(he - r.end_ns) / 1e3:.1f} us")
        assert r.start_ns < ks and ke <= r.end_ns
        assert abs(hs - r.start_ns) <= TOL_NS and abs(he - r.end_ns) <= TOL_NS


@pytest.mark.cuda
def test_count_batch_on_the_card_spans_each_graph_check_and_replay(cuda_device):
    from countr_tpu_torch.engine.inference import CountingEngine
    from countr_tpu_torch.models import build_countr

    model = build_countr(device=cuda_device, dtype=torch.bfloat16, use_pallas_attention=True,
                         approx_gelu=True, subpixel_head=True, **TINY)
    engine = CountingEngine(model, batch_windows=8, device=cuda_device)
    rng = np.random.default_rng(4)
    widths = (384, 600, 464, 1000)
    plain = [(40, 40, 110, 120), (150, 60, 230, 140), (250, 200, 330, 300)]
    rects = [plain, plain, [(5, 5, 12, 12), (50, 50, 120, 130), (10, 20, 60, 80)], plain]
    images = [rng.integers(0, 256, (384, w, 3), dtype=np.uint8) for w in widths]
    boxes = [rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32) for _ in images]
    engine.count_batch(images, boxes, rects, 3)  # captures the graphs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.count_batch(images, boxes, rects, 3)
    names = _by_name(tprof.span_log())
    forwards = names["count.forward"]
    assert "graph.capture" not in names
    for kind in ("graph.check", "graph.replay"):  # one in each chunk's forward
        assert sorted(r.parent for r in names[kind]) == sorted(r.id for r in forwards)
    assert not any(n.startswith(tprof.SPAN_PREFIX) for n in _events(prof, host=False))
