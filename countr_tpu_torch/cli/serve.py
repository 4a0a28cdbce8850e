"""HTTP counting service on the port (counterpart of
``countr_tpu/cli/serve.py``): POST an image, get a count. Requests from
concurrent clients are pooled into ``count_batch`` calls by a
micro-batching worker.

  python -m countr_tpu_torch.cli.serve --resume weights.pth --port 8700 \\
      --warmup_sizes 640x480,1024x768 --warmup_grid

  POST /count            body: image bytes (jpeg/png)
       ?boxes=x1,y1,x2,y2;...   optional exemplar boxes (original px)
  -> {"count": float, "grid_mode": bool, "n_windows": int, "ms": float}
  GET /healthz -> {"ok": true}

Threads: the handler threads decode, resize and crop on the host only
(PIL, cv2, numpy) and never touch the card. Only the micro-batching
worker calls the engine, and so only it launches work on the card or
captures a CUDA graph (a capture is ``relaxed``, engine/graphs.py, and a
CUDA call from another thread during it would break it). ``warmup``
captures every graph the worker can need before the server takes
traffic.
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from countr_tpu_torch.cli import common


def get_args(argv=None):
    p = argparse.ArgumentParser("counting service")
    common.add_model_args(p, default_model="mae_vit_base6_patch16")
    p.add_argument("--host", default="127.0.0.1", type=str)
    p.add_argument("--port", default=8700, type=int)
    p.add_argument("--batch_windows", default=16, type=int)
    p.add_argument("--max_batch_images", default=16, type=int)
    p.add_argument("--batch_wait_ms", default=5.0, type=float,
                   help="micro-batching window")
    p.add_argument("--no_normalization", action="store_true")
    p.add_argument("--warmup_sizes", default="", type=str,
                   help="comma list of WxH image sizes (original pixels) to run "
                        "before accepting traffic: for each size, every upload-row "
                        "bucket at 3 shots and zero-shot; then the window forward's "
                        "graph at every window bucket and shot count, so no request "
                        "pays a capture")
    p.add_argument("--warmup_grid", action="store_true",
                   help="also run the 3x3 grid-mode path (tiny exemplars) for each "
                        "warmup size, alone and mixed with plain images")
    return p.parse_args(argv)


class CountingService:
    """Micro-batching wrapper: concurrent requests with the same shot
    count ride one count_batch call, made by one worker thread."""

    def __init__(self, engine, max_batch: int, wait_ms: float):
        self.engine = engine
        self.max_batch = max_batch
        self.wait_s = wait_ms / 1000.0
        self.q: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, image, boxes, rects, shot):
        done = threading.Event()
        slot = {"done": done}
        self.q.put((image, boxes, rects, shot, slot))
        done.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["result"]

    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker once the queued requests are answered."""
        self.q.put(None)
        self._worker.join(timeout)

    def _loop(self):
        stop = False
        while not stop:
            first = self.q.get()
            if first is None:
                return
            batch = [first]
            deadline = time.perf_counter() + self.wait_s
            while len(batch) < self.max_batch:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    item = self.q.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                batch.append(item)
            by_shot: dict = {}
            for item in batch:
                by_shot.setdefault(item[3], []).append(item)
            for shot, items in by_shot.items():
                try:
                    results = self.engine.count_batch(
                        [it[0] for it in items],
                        [it[1] for it in items],
                        [it[2] for it in items],
                        shot_num=shot,
                        return_density=False,
                    )
                except Exception as e:  # the worker keeps serving; each request gets the error
                    for it in items:
                        it[4]["error"] = repr(e)
                        it[4]["done"].set()
                    continue
                for it, r in zip(items, results):
                    it[4]["result"] = r
                    it[4]["done"].set()


def decode_request(raw: bytes, boxes_q: str):
    """Request bytes and the ``boxes`` query -> (uint8 image [384, W, 3],
    exemplar crops or None, rects (y1, x1, y2, x2)), on the host with PIL
    and cv2 as the test pipeline (reference:
    FSC_test_cross(few-shot).py:134-172)."""
    from PIL import Image

    from countr_tpu_torch.cli.demo import parse_boxes
    from countr_tpu_torch.data import transforms as T

    return T.prepare_raw(Image.open(io.BytesIO(raw)), parse_boxes(boxes_q), u8=True)


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, {"ok": True})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if not self.path.startswith("/count"):
                self._json(404, {"error": "not found"})
                return
            try:
                raw = self.rfile.read(int(self.headers.get("Content-Length", "0")))
                boxes_q = parse_qs(urlparse(self.path).query).get("boxes", [""])[0]
                image, boxes, rects = decode_request(raw, boxes_q)
                t0 = time.perf_counter()
                r = service.submit(image, boxes, rects, len(rects))
                self._json(200, {
                    "count": r.count,
                    "grid_mode": r.grid_mode,
                    "n_windows": r.n_windows,
                    "ms": round((time.perf_counter() - t0) * 1e3, 1),
                })
            except Exception as e:  # a bad request or a failed count: answered, not fatal
                self._json(400, {"error": repr(e)})

    return Handler


class CountingServer(ThreadingHTTPServer):
    """The HTTP server over a ``CountingService``; ``server_close`` stops
    the service's worker too."""

    def __init__(self, address, service: CountingService):
        super().__init__(address, make_handler(service))
        self.service = service

    def server_close(self) -> None:
        super().server_close()
        self.service.close()


def serve(args, engine) -> CountingServer:
    """The server (not yet serving: call ``serve_forever``) and its
    micro-batching worker over ``engine``."""
    service = CountingService(engine, args.max_batch_images, args.batch_wait_ms)
    server = CountingServer((args.host, args.port), service)
    print(f"counting service on http://{args.host}:{server.server_address[1]}", flush=True)
    return server


def warmup(engine, sizes: str, max_batch: int, grid: bool = False) -> int:
    """Run, before any traffic, what the micro-batcher can produce for
    the given image sizes: one batch per upload-row bucket
    (CountingEngine._row_bucket) at 3 shots and zero-shot, and with
    ``grid`` one grid-mode image alone and mixed into each plain batch
    bucket. Then capture the window forward's CUDA graph at every window
    bucket for every shot count (``CountingEngine.capture_forwards``), so
    that served traffic captures nothing. Returns the graphs held."""
    import numpy as np

    from countr_tpu_torch.data import transforms as T

    buckets = sorted({engine._row_bucket(n) for n in range(1, max_batch + 1)})
    for part in sizes.split(","):
        w0, h0 = (int(v) for v in part.lower().split("x"))
        nh, nw = T.test_size(h0, w0)
        img = np.zeros((nh, nw, 3), np.uint8)
        img_f = img.astype(np.float32) / 255.0
        rects = [[10, 10, 60, 60], [80, 80, 140, 140], [200, 200, 260, 260]]
        boxes = T.crop_exemplars(img_f, rects, max_boxes=3)
        for nb in buckets:
            for shot, bx, rc in ((3, boxes, rects), (0, None, [])):
                t0 = time.perf_counter()
                engine.count_batch([img] * nb, [bx] * nb, [rc] * nb, shot_num=shot,
                                   return_density=False)
                print(f"warmup {w0}x{h0} batch {nb} shot {shot}: "
                      f"{time.perf_counter() - t0:.1f}s", flush=True)
        if grid:
            # <10x10 px exemplars trigger the 3x3 grid path
            # (reference: FSC_test_cross(few-shot).py:264-284)
            tiny = [[10, 10, 15, 15], [30, 30, 36, 36], [50, 50, 55, 55]]
            tboxes = T.crop_exemplars(img_f, tiny, max_boxes=3)
            for nb in sorted({1, *buckets}):
                t0 = time.perf_counter()
                engine.count_batch([img] * nb, [tboxes] + [boxes] * (nb - 1),
                                   [tiny] + [rects] * (nb - 1), shot_num=3,
                                   return_density=False)
                print(f"warmup {w0}x{h0} grid+{nb - 1} plain: "
                      f"{time.perf_counter() - t0:.1f}s", flush=True)
    graphs = engine.capture_forwards()
    print(f"warmup: {graphs} forward graphs captured", flush=True)
    return graphs


def main(args):
    engine = common.build_engine(args, normalization=not args.no_normalization)
    if args.warmup_sizes:
        warmup(engine, args.warmup_sizes, args.max_batch_images, grid=args.warmup_grid)
    serve(args, engine).serve_forever()


def _entry():
    main(get_args())


if __name__ == "__main__":
    _entry()
