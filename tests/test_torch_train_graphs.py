"""The training and eval steps replayed from CUDA graphs
(countr_tpu_torch/engine/train.py on engine/graphs.py) against the same
steps run eagerly on the card, from the same start.

Every case needs the card (marker ``cuda``; it skips without one; no JAX,
so it runs there with ``python -m pytest --noconftest
tests/test_torch_train_graphs.py``). Tiny widths at the full 384 window,
the bf16 training builds: CounTR with B1 and B3/B4 (B2 off, encoder
frozen), the MAE with B1 and B3/B4 or with B2 (its backward through
B3/B4). The eager steps launch the same fused AdamW kernel, so the two agree
to the bit:

- finetune over six mini-steps of four shots, one graph per shot: every
  loss, parameter and Adam tensor; each replay counts the kernels the
  eager step launches, and no wrapper launches during the replays;
- pretrain in both builds, the masking noise drawn inside the step from a
  generator reseeded before each step;
- accumulation at ``accum_iter`` 2: two graphs per shot, the parameters
  unchanged on the mini-steps that accumulate;
- eval captured before training and replayed after three steps (its bf16
  weight casts are inside the graph) against eager eval;
- a checkpoint restored into a state whose graphs were captured: no
  graph is captured again, and the run goes on as the uninterrupted one;
- a capture that fails raises, and the state is as before the call.

On the CPU: ``casts_at_use``, which keeps a captured step's weight casts
inside its graph.
"""

import numpy as np
import pytest
import torch

from countr_tpu_torch.config import TrainConfig
from countr_tpu_torch.engine import checkpoint as ckpt
from countr_tpu_torch.engine import train as ttrain
from countr_tpu_torch.models import build_countr, build_mae
from countr_tpu_torch.ops.launches import launch_counts, reset_launch_counts

TINY = dict(embed_dim=64, depth=2, num_heads=4, decoder_embed_dim=64, decoder_depth=2,
            decoder_num_heads=4, head_width=32)
TRAIN_FAST = dict(dtype=torch.bfloat16, use_pallas_attention=True, approx_gelu=True,
                  subpixel_head=True, fused_attn_block=False)
TINY_MAE = dict(embed_dim=64, depth=2, num_heads=4, decoder_embed_dim=64, decoder_depth=2,
                decoder_num_heads=4)
B = 2
SHOTS = [3, 2, 0, 1, 3, 0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the kernels have no CPU mode)")
    return torch.device("cuda")


def cfg(accum: int = 1) -> TrainConfig:
    """One warmup epoch of two updates; under accumulation none, so that
    the first update moves the weights."""
    return TrainConfig(batch_size=B, epochs=4, warmup_epochs=int(accum == 1), lr=1e-3,
                       accum_iter=accum)


def finetune_batch(dev, i: int) -> dict:
    rng = np.random.default_rng(60 + i)
    b = {"image": rng.uniform(0, 1, (B, 384, 384, 3)),
         "gt_density": 0.05 * rng.uniform(0, 1, (B, 384, 384)),
         "boxes": rng.uniform(0, 1, (B, 3, 64, 64, 3)),
         "valid": np.array([1.0, 0.0])}
    return {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in b.items()}


def finetuner(dev, graphed: bool, accum: int = 1, seed: int = 0):
    model = build_countr(device=dev, seed=seed, training=True, **TINY, **TRAIN_FAST)
    state = ttrain.init_train_state(model, cfg(accum), steps_per_epoch=2, world_batch=B)
    gen = torch.Generator(device=dev)
    return state, ttrain.make_finetune_step(state, cfg(accum), gen, graphed=graphed), gen


def run(state, step, gen, steps) -> list:
    losses = []
    for i in steps:
        gen.manual_seed(100 + i)
        losses.append(step(finetune_batch(state.device, i), SHOTS[i])["loss"].item())
    return losses


def assert_same_state(a, b) -> None:
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    for p, q in zip(a.params, b.params):
        for x, y in zip(a.moments(p), b.moments(q)):
            assert torch.equal(x, y)
    for x, y in zip(a.acc, b.acc):
        assert torch.equal(x, y)
    assert (a.step, a.updates) == (b.step, b.updates)


@pytest.mark.cuda
def test_graphed_finetune_equals_eager(cuda_device):
    g, e = finetuner(cuda_device, True), finetuner(cuda_device, False)
    for s in sorted(set(SHOTS)):
        g[1].capture(finetune_batch(cuda_device, 0), s)
    assert len(g[1].runner) == 4
    assert_same_state(g[0], e[0])  # the captures took no step

    reset_launch_counts()
    eager = run(*e, range(len(SHOTS)))
    eager_launches = launch_counts()
    reset_launch_counts()
    g[1].runner.zero_counts()
    graphed = run(*g, range(len(SHOTS)))
    assert launch_counts() == dict.fromkeys(eager_launches, 0)
    assert g[1].runner.replays == len(SHOTS)
    assert g[1].runner.launched == eager_launches
    assert eager_launches["B3"] > 0 and eager_launches["B4"] > 0 and eager_launches["B1"] > 0
    assert graphed == eager
    assert_same_state(g[0], e[0])
    assert len(g[1].runner) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["cli_build", "b2_on"])
def test_graphed_pretrain_equals_eager(cuda_device, fused):
    rng = np.random.default_rng(7)
    imgs = torch.from_numpy(rng.uniform(0, 1, (B, 384, 384, 3)).astype(np.float32))
    imgs = imgs.to(cuda_device)
    runs = []
    for graphed in (True, False):
        model = build_mae(device=cuda_device, seed=0, fused_attn_block=fused, **TINY_MAE)
        state = ttrain.init_train_state(model, cfg(), steps_per_epoch=2, world_batch=B)
        gen = torch.Generator(device=cuda_device)
        step = ttrain.make_pretrain_step(state, cfg(), gen, graphed=graphed)
        losses = []
        for i in range(4):
            gen.manual_seed(i % 2)  # noise drawn in the step: two draws, each twice
            losses.append(step(imgs)["loss"].item())
        runs.append((state, step, losses))
    (gs, gstep, gl), (es, _, el) = runs
    assert len(gstep.runner) == 1 and gstep.runner.replays == 4
    assert gl == el and gl[0] != gl[1]
    assert_same_state(gs, es)


@pytest.mark.cuda
def test_graphed_accumulation_equals_eager(cuda_device):
    g, e = finetuner(cuda_device, True, accum=2), finetuner(cuda_device, False, accum=2)
    shots = [3, 3, 0, 0]
    for s in set(shots):
        g[1].capture(finetune_batch(cuda_device, 0), s)
    assert len(g[1].runner) == 4  # accumulate and update, per shot
    for i, s in enumerate(shots):
        before = [p.clone() for p in g[0].params]
        for state, step, gen in (g, e):
            gen.manual_seed(100 + i)
            step(finetune_batch(cuda_device, i), s)
        assert_same_state(g[0], e[0])
        unchanged = all(torch.equal(p, q) for p, q in zip(g[0].params, before))
        assert unchanged == (i % 2 == 0), i
    assert g[0].updates == 2 and g[1].runner.replays == 4 and len(g[1].runner) == 4


@pytest.mark.cuda
def test_eval_graph_follows_the_training_weights(cuda_device):
    state, step, gen = finetuner(cuda_device, True)
    ev_g = ttrain.make_eval_step(state.model)
    ev_e = ttrain.make_eval_step(state.model, graphed=False)
    b = finetune_batch(cuda_device, 9)
    first = []
    for shot in (3, 0):
        reset_launch_counts()
        want = ev_e(b, shot)
        eager = launch_counts()
        ev_g.runner.zero_counts()
        got = ev_g(b, shot)  # captured, then replayed once
        assert {k: torch.equal(got[k], want[k]) for k in want} == dict.fromkeys(want, True)
        assert ev_g.runner.launched == eager and eager["B4"] == 0 and eager["B3"] > 0
        first.append(got)
    run(state, step, gen, range(3))
    for shot, old in zip((3, 0), first):
        want, got = ev_e(b, shot), ev_g(b, shot)
        assert {k: torch.equal(got[k], want[k]) for k in want} == dict.fromkeys(want, True)
        assert not torch.equal(got["err_sum"], old["err_sum"])
    assert len(ev_g.runner) == 2


@pytest.mark.cuda
def test_restore_keeps_the_graphs_valid(cuda_device, tmp_path):
    ref = finetuner(cuda_device, True)
    want = run(*ref, range(4))
    first = finetuner(cuda_device, True)
    run(*first, range(2))
    ckpt.save_checkpoint(str(tmp_path), 2, first[0])

    other = finetuner(cuda_device, True, seed=5)
    run(*other, range(4))  # captures the four shots' graphs
    captured = len(other[1].runner)
    ckpt.restore_checkpoint(str(tmp_path), other[0])
    assert run(*other, range(2, 4)) == want[2:]
    assert len(other[1].runner) == captured
    assert_same_state(other[0], ref[0])


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda_device, monkeypatch):
    state, step, gen = finetuner(cuda_device, True)
    before = [t.clone() for t in state.mutable()]
    real = ttrain.count_errors

    def host_sync(out, gt):  # a host read: no stream capture admits it
        err = real(out, gt)
        return err * float(err.sum() >= 0)

    monkeypatch.setattr(ttrain, "count_errors", host_sync)
    with pytest.raises(RuntimeError):
        step(finetune_batch(cuda_device, 0), 3)
    assert len(step.runner) == 0 and step.runner.replays == 0 and state.step == 0
    torch.cuda.synchronize()
    assert all(torch.equal(t, s) for t, s in zip(state.mutable(), before))


def test_casts_at_use_read_no_cached_copy():
    """What keeps a captured step valid when the weights change in place:
    within ``casts_at_use`` the bf16 copy is made at each use (inside the
    graph), not read from the cache whose address a graph would keep."""
    from countr_tpu_torch.models.vit import cast_param, casts_at_use

    p = torch.nn.Parameter(torch.arange(4.0))
    with torch.no_grad():
        cached = cast_param(p, torch.bfloat16)
        assert cast_param(p, torch.bfloat16) is cached
        with casts_at_use():
            fresh = cast_param(p, torch.bfloat16)
        assert fresh is not cached and torch.equal(fresh, cached)
        assert cast_param(p, torch.bfloat16) is cached
