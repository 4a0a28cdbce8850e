"""The port's HTTP counting service (device="cpu") against the JAX
package's (the pattern of tests/test_serve.py), on the same request bytes
and the same tiny fp32 weights (the weight bridge of
tests/torch_port_helpers.py): counts within 1e-4 relative (the tolerance
of tests/test_torch_count_batch.py:72), with and without exemplar boxes
and in grid mode; 4 concurrent requests; /healthz, 404 and 400; the
warm-up's batches."""

import argparse
import io
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from countr_tpu.cli import serve as jserve
from countr_tpu.engine.inference import CountingEngine as JaxEngine
from countr_tpu_torch.cli import serve as tserve
from countr_tpu_torch.engine.inference import CountingEngine as TorchEngine
from tests.torch_port_helpers import jax_model, torch_model

SMALL = dict(embed_dim=32, depth=1, num_heads=2, decoder_embed_dim=32, decoder_depth=1,
             decoder_num_heads=2, head_width=32)
SERVE_ARGS = argparse.Namespace(host="127.0.0.1", port=0, max_batch_images=4, batch_wait_ms=20.0)


def _start(mod, engine):
    srv = mod.serve(SERVE_ARGS, engine)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def servers():
    model, params = jax_model(seed=3, jit=True, **SMALL)
    jsrv, jurl = _start(jserve, JaxEngine(model, params, batch_windows=4))
    tengine = TorchEngine(torch_model(params, **SMALL), batch_windows=4, device="cpu")
    tsrv, turl = _start(tserve, tengine)
    yield jurl, turl, tengine
    jsrv.shutdown()
    tsrv.shutdown()
    tsrv.server_close()
    assert not tsrv.service._worker.is_alive()


def _jpeg(seed, h, w):
    buf = io.BytesIO()
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def _post(url, data, query=""):
    req = urllib.request.Request(f"{url}/count{query}", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


REQUESTS = [
    (0, 500, 700, ""),  # zero-shot
    (1, 400, 600, "?boxes=10,20,80,90;120,130,200,210;300,40,360,110"),  # few-shot
    (2, 384, 640, "?boxes=10,20,16,26;120,130,200,210;300,40,360,110"),  # a tiny box: grid mode
    (3, 300, 300, "?boxes=10,20,80,90"),  # one exemplar, narrower than a window
]


@pytest.mark.parametrize("case", range(len(REQUESTS)))
def test_count_matches_jax(servers, case):
    jurl, turl, _ = servers
    seed, h, w, query = REQUESTS[case]
    data = _jpeg(seed, h, w)
    want, got = _post(jurl, data, query), _post(turl, data, query)
    assert got["grid_mode"] == want["grid_mode"] == (case == 2)
    assert got["n_windows"] == want["n_windows"]
    assert got["count"] == pytest.approx(want["count"], rel=1e-4, abs=1e-4)
    assert got["ms"] >= 0


def test_concurrent_requests(servers):
    """Four requests at once ride the micro-batcher (pooled by shot count)
    and each gets its own answer: the one it gets alone."""
    _, turl, _ = servers
    cases = [REQUESTS[0], REQUESTS[1], (4, 400, 600, REQUESTS[1][3]), (5, 500, 700, "")]
    alone = [_post(turl, _jpeg(s, h, w), q) for s, h, w, q in cases]
    with ThreadPoolExecutor(max_workers=4) as pool:
        together = list(pool.map(lambda c: _post(turl, _jpeg(c[0], c[1], c[2]), c[3]), cases))
    for a, t in zip(alone, together):
        assert t["n_windows"] == a["n_windows"]
        assert t["count"] == pytest.approx(a["count"], rel=1e-4, abs=1e-4)


def test_healthz_404_400(servers):
    _, turl, _ = servers
    with urllib.request.urlopen(f"{turl}/healthz", timeout=30) as r:
        assert json.load(r) == {"ok": True}
    for req in (urllib.request.Request(f"{turl}/nope"),
                urllib.request.Request(f"{turl}/nope", data=b"x", method="POST")):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 404
    for data, query in ((b"not an image", ""), (_jpeg(0, 100, 100), "?boxes=1,2,3")):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(turl, data, query)
        assert e.value.code == 400
        assert "error" in json.load(e.value)


def test_warmup_runs_the_jax_batches(servers):
    """warmup runs the JAX package's warm-up batches (every row bucket at 3
    shots and zero-shot, and with ``grid`` a grid-mode image alone and
    mixed into each bucket); on the CPU there is no graph to capture."""
    _, _, tengine = servers
    calls = []
    orig = tengine.count_batch

    def spy(images, boxes, rects, shot_num, **kw):
        n_tiny = sum(1 for r in rects if r and r[0][2] - r[0][0] < 10)
        calls.append((len(images), n_tiny, shot_num))
        return orig(images, boxes, rects, shot_num=shot_num, **kw)

    tengine.count_batch = spy
    try:
        assert tserve.warmup(tengine, "400x384", max_batch=4, grid=True) == 0
    finally:
        del tengine.count_batch
    plain = {(4, 0, 3), (4, 0, 0)}
    grid = {(1, 1, 3), (4, 1, 3)}
    assert set(calls) == plain | grid and len(calls) == 4
