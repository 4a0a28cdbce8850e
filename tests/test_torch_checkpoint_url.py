"""Checkpoint URLs in the port's ``load_torch_checkpoint``
(countr_tpu_torch/engine/checkpoint.py ``_fetch_if_url``, the port's copy
of countr_tpu/engine/checkpoint.py's), on the CPU, tiny models, ``HOME``
in a temporary directory.

- ``file://`` and a loopback ``http://`` URL load the same tensors as the
  local path; the cached file is named as the JAX package names it for
  the same URL (``sha1(url)[:16] + "_" + basename``).
- A second load is a cache hit (the server counts its GETs); a 404 raises
  and leaves no ``.part`` file; 8 threads fetching at once all load the
  same tensors and leave one file.
- The CLIs take such a URL where they take a ``.pth``: ``--resume`` of
  ``cli.common.build_counting_model`` and of the pretrain CLI's
  ``build_mae_model``, and the finetune CLI's ``--init_from_mae``
  (``init_encoder``), each equal to the load from the local path.

No network: the only server is one on 127.0.0.1 started by the test.
"""

import argparse
import functools
import http.server
import os
import threading

import pytest
import torch

from countr_tpu_torch import config as tcfg
from countr_tpu_torch.engine import checkpoint as ckpt
from countr_tpu_torch.models import build_countr, build_mae
from tests import torch_port_helpers  # noqa: F401  (one intra-op thread)

TINY = dict(img_size=64, patch_size=16, embed_dim=32, depth=1, num_heads=2,
            decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2, head_width=32)
TINY_MAE = dict(img_size=64, patch_size=16, embed_dim=32, depth=1, num_heads=2,
                decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)


@pytest.fixture
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    return tmp_path / "home"


def _cache(home):
    return home / ".cache" / "countr_tpu_torch" / "ckpts"


@pytest.fixture
def served(tmp_path):
    """A directory of checkpoints served on 127.0.0.1: (directory, base
    URL, list of GET paths)."""
    root = tmp_path / "srv"
    root.mkdir()
    gets = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def do_GET(self):
            gets.append(self.path)
            super().do_GET()

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Handler, directory=str(root)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield root, f"http://127.0.0.1:{server.server_address[1]}", gets
    finally:
        server.shutdown()
        server.server_close()


def _countr_pth(path, seed=3):
    model = build_countr(device="cpu", seed=seed, **TINY)
    torch.save({"model": model.state_dict(), "epoch": 1}, path)
    return str(path)


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_local_path_passes_through(tmp_path, home):
    pth = _countr_pth(tmp_path / "w.pth")
    assert ckpt._fetch_if_url(pth) == pth
    assert not _cache(home).exists()


def test_file_url_loads_the_local_file_under_jax_cache_name(tmp_path, home):
    from countr_tpu.engine.checkpoint import _fetch_if_url as jax_fetch

    pth = _countr_pth(tmp_path / "w.pth")
    url = "file://" + pth
    got = ckpt.load_torch_checkpoint(url)
    _assert_same(got, ckpt.load_torch_checkpoint(pth))
    (cached,) = os.listdir(_cache(home))
    assert cached == os.path.basename(jax_fetch(url))
    assert cached.endswith("_w.pth") and not cached.endswith(".part")


def test_http_url_loads_once_then_hits_the_cache(served, tmp_path, home):
    root, base, gets = served
    pth = _countr_pth(root / "countr.pth")
    url = f"{base}/countr.pth"
    first = ckpt.load_torch_checkpoint(url)
    _assert_same(first, ckpt.load_torch_checkpoint(pth))
    assert gets == ["/countr.pth"]
    _assert_same(ckpt.load_torch_checkpoint(url), first)
    assert gets == ["/countr.pth"]  # the second load made no request
    assert [p.name for p in _cache(home).iterdir()] == [os.path.basename(ckpt._fetch_if_url(url))]


def test_failed_fetch_raises_and_leaves_nothing(served, home):
    _, base, gets = served
    with pytest.raises(OSError):  # urllib's HTTPError: 404
        ckpt.load_torch_checkpoint(f"{base}/missing.pth")
    assert gets == ["/missing.pth"]
    assert list(_cache(home).iterdir()) == []


def test_concurrent_fetchers_get_the_same_file(served, home):
    root, base, _ = served
    pth = _countr_pth(root / "countr.pth")
    want = ckpt.load_torch_checkpoint(pth)
    url = f"{base}/countr.pth"
    start = threading.Barrier(8)
    got, errors = [None] * 8, []

    def fetch(i):
        try:
            start.wait()
            got[i] = ckpt.load_torch_checkpoint(url)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    for sd in got:
        _assert_same(sd, want)
    assert len(list(_cache(home).iterdir())) == 1  # no .part file left


def test_resume_url_builds_the_local_model(served, monkeypatch, home):
    from countr_tpu_torch.cli.common import build_counting_model

    root, base, _ = served
    pth = _countr_pth(root / "countr.pth", seed=5)
    monkeypatch.setitem(tcfg.COUNTR_PRESETS, "tiny_url", tcfg.CounTRConfig(**TINY))
    models = []
    for resume in (pth, f"{base}/countr.pth", "file://" + pth):
        args = argparse.Namespace(model="tiny_url", device="cpu", seed=0, dtype="fp32",
                                  resume=resume)
        models.append(build_counting_model(args).state_dict())
    _assert_same(models[1], models[0])
    _assert_same(models[2], models[0])


def test_pretrain_resume_url_loads_the_local_mae(served, monkeypatch, home):
    from countr_tpu_torch.cli.pretrain import build_mae_model

    root, base, _ = served
    mae = build_mae(device="cpu", dtype="fp32", seed=4, **TINY_MAE)
    pth = str(root / "mae.pth")
    torch.save({"model": mae.state_dict()}, pth)
    monkeypatch.setitem(tcfg.MAE_PRESETS, "tiny_url_mae", tcfg.MAEConfig(**TINY_MAE))
    models = []
    for resume in (pth, f"{base}/mae.pth"):
        args = argparse.Namespace(model="tiny_url_mae", device="cpu", seed=0, dtype="fp32",
                                  mask_ratio=0.5, norm_pix_loss=False, exact_gelu=False,
                                  masked_loss=False, resume=resume)
        models.append(build_mae_model(args).state_dict())
    _assert_same(models[1], models[0])
    _assert_same(models[0], mae.state_dict())


def test_init_from_mae_url_gives_the_local_encoder(served, home):
    from countr_tpu_torch.cli.finetune import init_encoder

    root, base, _ = served
    mae = build_mae(device="cpu", dtype="fp32", seed=6, **TINY_MAE)
    pth = str(root / "mae.pth")
    torch.save({"model": mae.state_dict()}, pth)
    encoders = []
    for path in (pth, f"{base}/mae.pth", "file://" + pth):
        model = build_countr(device="cpu", seed=0, training=True, **TINY)
        init_encoder(model, path)
        encoders.append(model.state_dict())
    _assert_same(encoders[1], encoders[0])
    _assert_same(encoders[2], encoders[0])
    assert torch.equal(encoders[0]["blocks.0.attn.qkv.weight"],
                       mae.state_dict()["blocks.0.attn.qkv.weight"])
