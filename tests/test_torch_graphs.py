"""The window forward replayed from CUDA graphs (countr_tpu_torch/engine/
graphs.py) and the batched engine on the card.

On the CPU: graphs need a CUDA device (the runner refuses another), and
the pipeline runs the forward eagerly there. On the card (marker
``cuda``; skips without one; no JAX, so it runs there with
``python -m pytest --noconftest tests/test_torch_graphs.py``), a tiny
bf16 fast-mode model (B1, B2): the replay gives the eager forward's bits,
at two window buckets; after ``load_state_dict`` the graphs are captured
again and the replay gives the new eager output's bits; each replay
counts B1 and B2 as the eager forward launches them, and the wrappers
count nothing for it; count_batch on the card agrees with count within
1e-2 relative (bf16 forwards at other batch neighbours and sizes, and a
float32 stitch on the card against float64 on the host).
"""

import numpy as np
import pytest
import torch

from countr_tpu_torch.engine.inference import CountingEngine
from countr_tpu_torch.models import build_countr
from countr_tpu_torch.ops.launches import launch_counts, reset_launch_counts

TINY = dict(embed_dim=64, depth=2, num_heads=4, decoder_embed_dim=64, decoder_depth=2,
            decoder_num_heads=4, head_width=32)
BF16_FAST = dict(dtype=torch.bfloat16, use_pallas_attention=True, approx_gelu=True,
                 subpixel_head=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the kernels have no CPU mode)")
    return torch.device("cuda")


def test_graph_runner_needs_a_cuda_device():
    from countr_tpu_torch.engine.graphs import GraphRunner

    with pytest.raises(ValueError, match="CUDA"):
        GraphRunner(torch.device("cpu"))


def test_pipeline_forward_is_eager_on_the_cpu():
    model = build_countr(device="cpu", **TINY)
    engine = CountingEngine(model, batch_windows=4, device="cpu")
    assert engine._pipeline.forward == model.forward_tokens


def _inputs(dev, b, seed):
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.uniform(0, 1, (b, 384, 384, 3)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal((b, 3, 64)).astype(np.float32)).to(dev, torch.bfloat16)
    return imgs, y


@pytest.mark.cuda
def test_graphed_forward_bitwise_and_recaptured_on_weight_change(cuda_device):
    model = build_countr(device=cuda_device, **TINY, **BF16_FAST)
    engine = CountingEngine(model, batch_windows=8)
    graphed = engine._pipeline.forward
    with torch.inference_mode():
        for b, seed in ((8, 0), (4, 1), (8, 2)):
            imgs, y = _inputs(cuda_device, b, seed)
            want = model.forward_tokens(imgs, y)
            assert torch.equal(graphed(imgs, y), want), (b, seed)
        assert len(graphed.runner) == 2
        old = want
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        sd["blocks.0.attn.qkv.weight"] *= 1.25
        sd["decode_head3.3.weight"] *= 1.25
    model.load_state_dict(sd)
    with torch.inference_mode():
        want = model.forward_tokens(imgs, y)
        got = graphed(imgs, y)
        assert torch.equal(got, want)
        assert not torch.equal(got, old)
        assert len(graphed.runner) == 1  # the old graphs were dropped


@pytest.mark.cuda
def test_replays_count_the_kernels_the_eager_forward_launches(cuda_device):
    model = build_countr(device=cuda_device, **TINY, **BF16_FAST)
    graphed = CountingEngine(model, batch_windows=4)._pipeline.forward
    imgs, y = _inputs(cuda_device, 4, 3)
    with torch.inference_mode():
        reset_launch_counts()
        model.forward_tokens(imgs, y)
        eager = launch_counts()
        graphed(imgs, y)  # warm-up launches and the capture
        reset_launch_counts()
        graphed.runner.zero_counts()
        for _ in range(3):
            graphed(imgs, y)
    # encoder: B2 and norm2 per block, the final norm; decoder: B2, norm1
    # and norm2 per block, the final norm
    assert eager["B1"] == 2 + 1 + 2 * 2 + 1 and eager["B2"] == 2 + 2
    assert launch_counts() == dict.fromkeys(eager, 0)
    assert graphed.runner.replays == 3
    assert graphed.runner.launched == {k: 3 * v for k, v in eager.items()}


@pytest.mark.cuda
def test_count_batch_on_the_card_agrees_with_count(cuda_device):
    model = build_countr(device=cuda_device, **TINY, **BF16_FAST)
    engine = CountingEngine(model, batch_windows=8)
    rng = np.random.default_rng(4)
    widths = (384, 600, 464, 300, 1000)
    rects = [[(40, 40, 110, 120), (150, 60, 230, 140), (250, 200, 330, 300)]] * 5
    rects[2] = [(5, 5, 12, 12), (50, 50, 120, 130), (10, 20, 60, 80)]  # grid mode
    images = [rng.integers(0, 256, (384, w, 3), dtype=np.uint8) for w in widths]
    boxes = [rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32) for _ in images]
    got = engine.count_batch(images, boxes, rects, 3)
    for i, g in enumerate(got):
        want = engine.count(images[i], boxes[i], rects[i])
        assert g.grid_mode == want.grid_mode and g.n_windows == want.n_windows
        assert np.isfinite(g.count) and g.density.shape == (384, widths[i])
        assert g.raw_count == pytest.approx(want.raw_count, rel=1e-2), i
        assert g.count == pytest.approx(want.count, rel=1e-2), i
