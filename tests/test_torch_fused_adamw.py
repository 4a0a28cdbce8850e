"""The training state's AdamW update (countr_tpu_torch/ops/fused_adamw.py,
through ``TrainState.apply_gradients``): one pass over flat float32
gradient and moment buffers and the parameters in place.

On the CPU (the plain version):

- 5 updates of ``TrainState`` against ``torch.optim.AdamW`` (foreach and
  fused off) on a copy of the same model, from the same gradients: a tiny
  CounTR (the frozen encoder in no group, both decay groups, a bias of one
  element) and a tiny MAE (every parameter trained), every parameter and
  moment within fp32 rounding;
- 3 updates against the JAX package's optax AdamW
  (``countr_tpu.engine.train.make_optimizer`` with the frozen encoder) on
  the same arrays, at tests/test_torch_train.py's tolerances;
- the kernel's chunk table: every element of every parameter once, at its
  flat offset, in 16-byte units where every parameter starts on 16 bytes
  and in elements where one does not;
- checkpoints between this layout (moments as views of flat buffers, one
  shared step count) and torch's own (a tensor per parameter, as an
  optimizer that steps itself keeps them): each restores into the other
  with ``step``, ``exp_avg`` and ``exp_avg_sq`` per parameter;
- the wrapper's refusals.

On the card (marker ``cuda``; skips without one; no JAX, run there with
``python -m pytest --noconftest -m cuda tests/test_torch_fused_adamw.py``),
at mae_base's 251 trainable tensors: 3 updates of the kernel against its
plain version, updates replayed from a CUDA graph against eager ones to
the bit, and one kernel launch per update.
"""

import copy

import numpy as np
import pytest
import torch
from torch import nn

from countr_tpu_torch.config import TrainConfig
from countr_tpu_torch.engine import checkpoint as ckpt
from countr_tpu_torch.engine import train as ttrain
from countr_tpu_torch.models import build_countr, build_mae
from countr_tpu_torch.ops import fused_adamw as fa

TINY = dict(img_size=64, embed_dim=32, depth=1, num_heads=2, decoder_embed_dim=32,
            decoder_depth=1, decoder_num_heads=2, head_width=32)
TINY_MAE = dict(embed_dim=32, depth=1, num_heads=2, decoder_embed_dim=32, decoder_depth=1,
                decoder_num_heads=2)
CFG = TrainConfig(batch_size=2, epochs=4, warmup_epochs=1, lr=1e-3, weight_decay=0.05)


def tiny_model(kind: str, seed: int = 0) -> nn.Module:
    if kind == "countr":
        return build_countr(device="cpu", seed=seed, training=True, **TINY)
    return build_mae(device="cpu", seed=seed, **TINY_MAE)


def gradients(state, k: int) -> list:
    """Update k's gradient of each of ``state``'s parameters, N(0, 1e-2)
    with a few exact zeros (Adam's ratio at v = 0)."""
    gen = torch.Generator().manual_seed(100 + k)
    out = []
    for p in state.params:
        g = 1e-2 * torch.randn(p.shape, generator=gen)
        g.view(-1)[::7] = 0.0
        out.append(g)
    return out


def update(state, grads) -> None:
    """One update of ``state`` from ``grads``, as a step makes it."""
    update_now = state.begin_step()
    for g, x in zip(state.grads, grads):
        g.copy_(x)
    state.apply_gradients(update_now)
    state.end_step(update_now)


class TorchLayoutState(ttrain.TrainState):
    """A ``TrainState`` whose optimizer keeps torch's own layout and
    updates itself: a step count and two moments of its own per parameter,
    ``optimizer.step()`` for the update (foreach and fused off)."""

    def __init__(self, model):
        opt, sched = ttrain.make_optimizer(model, CFG, 2, CFG.batch_size)
        for g in opt.param_groups:
            g["foreach"], g["fused"] = False, None
        super().__init__(model, opt, sched)
        for p in self.params:
            st = opt.state[p]
            opt.state[p] = {"step": st["step"].clone(), "exp_avg": st["exp_avg"].clone(),
                            "exp_avg_sq": st["exp_avg_sq"].clone()}

    def apply_gradients(self, update: bool) -> None:
        if update:
            self.optimizer.step()


@pytest.mark.parametrize("kind", ["countr", "mae"])
def test_plain_update_matches_torch_adamw(kind):
    model = tiny_model(kind)
    ref = TorchLayoutState(copy.deepcopy(model))
    state = ttrain.init_train_state(model, CFG, 2, CFG.batch_size)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not any(p is q for q in state.params)}
    assert (kind == "countr") == bool(frozen)
    # countr: segments that end short of FLAT_ALIGN, down to a bias of one element
    assert (kind == "countr") == any(p.numel() % fa.FLAT_ALIGN for p in state.params)
    assert 0 < state.segments.decay_end < state.segments.length
    for k in range(5):
        grads = gradients(state, k)
        update(state, grads)
        update(ref, grads)
    assert float(state.adam_step) == 5 and state.updates == 5
    for (name, p), q in zip(model.named_parameters(), ref.model.parameters()):
        if name in frozen:
            assert torch.equal(p, frozen[name]) and not state.optimizer.state.get(p), name
            continue
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7, msg=name)
        for a, b in zip(state.moments(p), ref.moments(q)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-12, msg=name)


@pytest.mark.parametrize("warmup_epochs", [0, 1], ids=["lr_from_step0", "warmup"])
def test_train_state_matches_optax(warmup_epochs):
    """A tree with the JAX package's top-level names (the frozen encoder's
    "patch_embed", "blocks_", "norm"), the port's module with the same
    leaves, 3 updates from the same gradients on both sides."""
    import jax
    import jax.numpy as jnp
    import optax

    from countr_tpu.config import TrainConfig as JaxTrainConfig
    from countr_tpu.engine import train as jtrain

    shapes = {"patch_embed": {"kernel": (12, 8)}, "blocks_0": {"kernel": (8, 8), "bias": (8,)},
              "norm": {"scale": (8,)}, "decoder": {"kernel": (37, 5), "bias": (5,)},
              "head": {"kernel": (64, 33), "bias": (1,)}, "token": {"value": (1, 1, 9)}}
    rng = np.random.default_rng(3)
    arrays = {k: {n: rng.standard_normal(s).astype(np.float32) for n, s in leaves.items()}
              for k, leaves in shapes.items()}

    class Tree(nn.Module):
        def __init__(self):
            super().__init__()
            self.cfg = type("Cfg", (), {"freeze_encoder": True})()
            for k, leaves in arrays.items():
                mod = nn.Module()
                for n, a in leaves.items():
                    mod.register_parameter(n, nn.Parameter(torch.from_numpy(a.copy())))
                setattr(self, "blocks" if k == "blocks_0" else k,
                        nn.ModuleList([mod]) if k == "blocks_0" else mod)

    def torch_name(k, n):
        return f"blocks.0.{n}" if k == "blocks_0" else f"{k}.{n}"

    kw = dict(batch_size=2, epochs=4, warmup_epochs=warmup_epochs, lr=1e-3, weight_decay=0.05)
    tx, _ = jtrain.make_optimizer(JaxTrainConfig(**kw), steps_per_epoch=2, world_batch=2,
                                  freeze_encoder=True)
    params = jax.tree.map(jnp.asarray, arrays)
    opt_state = tx.init(params)
    model = Tree()
    state = ttrain.init_train_state(model, TrainConfig(**kw), 2, 2)
    named = dict(model.named_parameters())
    assert len(state.params) == 5  # the frozen encoder's four leaves in no group
    for k in range(3):
        g = {key: {n: rng.standard_normal(a.shape).astype(np.float32) * 1e-2
                   for n, a in leaves.items()} for key, leaves in arrays.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)
        update(state, [torch.from_numpy(g[key][n]) for p in state.params
                       for key, leaves in g.items() for n in leaves
                       if named[torch_name(key, n)] is p])
    mu = optax.tree_utils.tree_get(opt_state, "mu")
    for key, leaves in arrays.items():
        for n in leaves:
            p = named[torch_name(key, n)]
            got, want = p.detach().numpy(), np.asarray(params[key][n])
            assert np.abs(got - want).max() <= 1e-5, (key, n)
            if p in state.optimizer.state:
                m, w = state.moments(p)[1].numpy(), np.asarray(mu[key][n])
                assert np.abs(m - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), (key, n)
            else:
                assert np.array_equal(got, leaves[n]), (key, n)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
def test_chunk_table_covers_every_element(aligned, monkeypatch):
    """The table the kernel reads, built from CPU parameters' addresses:
    every element once, each chunk at most BLOCK long and at its flat
    offset."""
    monkeypatch.setattr(fa, "BLOCK", 64)
    store = torch.zeros(4096)
    shapes = [(7, 5), (130,), (1,), (64,), (3, 33)]
    params, off = [], 0 if aligned else 1
    for s in shapes:
        n = int(np.prod(s))
        params.append(store[off:off + n].view(s))
        off += -(-n // 4) * 4 + (0 if aligned else 4)
    seg = fa.AdamWSegments(params, decay_count=2)
    table, align = seg._chunk_table()
    assert align == (4 if aligned else 1)
    base = params[0].data_ptr()
    seen = torch.zeros(store.numel(), dtype=torch.int64)
    for prel, foff, n in table.tolist():
        assert 0 < n <= fa.BLOCK
        start = (base - store.data_ptr()) // 4 + prel * align
        i = next(i for i, p in enumerate(params)
                 if p.data_ptr() // 4 <= store.data_ptr() // 4 + start
                 < p.data_ptr() // 4 + p.numel())
        local = start - (params[i].data_ptr() - store.data_ptr()) // 4
        assert foff * align == seg.offsets[i] + local and local + n <= params[i].numel()
        seen[start:start + n] += 1
    want = torch.zeros_like(seen)
    for p in params:
        s = (p.data_ptr() - store.data_ptr()) // 4
        want[s:s + p.numel()] = 1
    assert torch.equal(seen, want)
    assert seg.decay_end == seg.offsets[2] and all(o % fa.FLAT_ALIGN == 0 for o in seg.offsets)


def test_checkpoints_cross_layouts(tmp_path):
    """Saved by the flat layout, restored into torch's, and back: the
    weights and each parameter's step, exp_avg and exp_avg_sq as saved;
    each state then steps on as the other."""
    flat = ttrain.init_train_state(tiny_model("countr", 0), CFG, 2, CFG.batch_size)
    for k in range(2):
        update(flat, gradients(flat, k))
    ckpt.save_checkpoint(str(tmp_path / "flat"), 2, flat)
    saved = torch.load(tmp_path / "flat" / "checkpoint-2.pth", weights_only=False)["optimizer"]
    assert len(saved["state"]) == len(flat.params)
    for i, p in enumerate(flat.params):
        st = saved["state"][i]
        assert sorted(st) == ["exp_avg", "exp_avg_sq", "step"]
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == p.shape
        assert st["step"].shape == () and float(st["step"]) == 2

    other = TorchLayoutState(tiny_model("countr", 1))
    assert ckpt.restore_checkpoint(str(tmp_path / "flat"), other) == 2
    assert_same(other, flat)
    steps = {id(other.moments(p)[0]) for p in other.params}
    assert len(steps) == len(other.params)  # still a count per parameter

    grads = gradients(flat, 2)
    update(flat, grads)
    update(other, grads)
    assert_same(other, flat, rtol=1e-6)
    ckpt.save_checkpoint(str(tmp_path / "torch"), 3, other)

    back = ttrain.init_train_state(tiny_model("countr", 2), CFG, 2, CFG.batch_size)
    ptrs = [t.data_ptr() for t in back.mutable()]
    assert ckpt.restore_checkpoint(str(tmp_path / "torch"), back) == 3
    assert [t.data_ptr() for t in back.mutable()] == ptrs
    assert_same(back, other)
    assert all(back.moments(p)[0] is back.adam_step for p in back.params)
    assert float(back.adam_step) == 3


def assert_same(a, b, rtol: float = 0.0) -> None:
    """Every parameter and Adam tensor of ``a`` and ``b`` equal (within
    ``rtol``), and the same counts."""
    for p, q in zip(a.params, b.params):
        torch.testing.assert_close(p, q, rtol=rtol, atol=0.0 if rtol == 0 else 1e-9)
        for x, y in zip(a.moments(p), b.moments(q)):
            torch.testing.assert_close(x, y, rtol=rtol, atol=0.0 if rtol == 0 else 1e-12)
    assert (a.step, a.updates) == (b.step, b.updates)


def test_wrapper_refusals():
    state = ttrain.init_train_state(tiny_model("mae"), CFG, 2, CFG.batch_size)
    seg, n = state.segments, state.segments.length
    kw = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.05)
    ok = (state.flat, state.exp_avg, state.exp_avg_sq, state.adam_step, 1e-3)
    for i, bad in ((0, torch.zeros(n, dtype=torch.float64)), (1, torch.zeros(n + 1)),
                   (2, torch.zeros(2 * n)[::2]), (3, torch.zeros(1))):
        args = list(ok)
        args[i] = bad
        with pytest.raises(ValueError):
            fa.fused_adamw(seg, *args, **kw)
    with pytest.raises(ValueError, match="float32"):
        fa.AdamWSegments([torch.zeros(3, dtype=torch.bfloat16)], 1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.AdamWSegments([torch.zeros(4, 4).t()], 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Triton kernel has no CPU mode)")
    return torch.device("cuda")


def mae_base_states(dev, n: int) -> list:
    """``n`` training states of the full-width MAE (seed 0), the same
    gradient N(0, 1e-3) in each and the learning rate on the device."""
    states = []
    for _ in range(n):
        model = build_mae("mae_vit_base_patch16", seed=0, device=dev)
        state = ttrain.init_train_state(model, TrainConfig(batch_size=16, warmup_epochs=0),
                                        100, 16)
        gen = torch.Generator(device=dev).manual_seed(0)
        for g in state.grads:
            g.normal_(0.0, 1e-3, generator=gen)
        states.append(state)
    return states


def apply_update(state, fn) -> None:
    state.begin_step()
    group = state.optimizer.param_groups[0]
    state.adam_step.add_(1)
    fn(state.segments, state.flat, state.exp_avg, state.exp_avg_sq, state.adam_step,
       group["lr"], beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=group["weight_decay"])


@pytest.mark.cuda
def test_kernel_matches_plain_at_mae_base(cuda_device):
    kernel, plain = mae_base_states(cuda_device, 2)
    assert len(kernel.params) == 251
    assert sum(p.numel() for p in kernel.params) == 111_654_912
    assert kernel.segments.align == 4
    lr = kernel.schedule(0)
    for _ in range(3):
        apply_update(kernel, fa.fused_adamw)
        apply_update(plain, fa.adamw_plain)
    with torch.no_grad():
        for p, q in zip(kernel.params, plain.params):
            assert float(((p - q).abs() / (q.abs() + 3 * lr)).max()) <= 1e-6
        for a, b in ((kernel.exp_avg, plain.exp_avg), (kernel.exp_avg_sq, plain.exp_avg_sq)):
            assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.cuda
def test_graphed_updates_equal_eager_at_mae_base(cuda_device):
    from countr_tpu_torch.engine.graphs import GraphRunner
    from countr_tpu_torch.ops.launches import launch_counts, reset_launch_counts

    graphed, eager = mae_base_states(cuda_device, 2)
    runner = GraphRunner(cuda_device, graphed.mutable)

    def device_update():
        graphed.apply_gradients(True)
        return {"step": graphed.adam_step.clone()}

    runner.capture("update", device_update)
    reset_launch_counts()
    for _ in range(3):
        graphed.begin_step()
        runner("update", device_update)
        graphed.end_step(True)
    assert launch_counts()["AdamW"] == 0 and runner.launched["AdamW"] == 3
    for _ in range(3):
        update_now = eager.begin_step()
        eager.apply_gradients(update_now)
        eager.end_step(update_now)
    assert launch_counts() == {**dict.fromkeys(launch_counts(), 0), "AdamW": 3}
    torch.cuda.synchronize()
    assert float(graphed.adam_step) == float(eager.adam_step) == 3
    for p, q in zip(graphed.params, eager.params):
        assert torch.equal(p, q)
    assert torch.equal(graphed.exp_avg, eager.exp_avg)
    assert torch.equal(graphed.exp_avg_sq, eager.exp_avg_sq)
