"""The port's gradient accumulation (countr_tpu_torch/engine/train.py
``TrainState``, ``accum_iter`` > 1) against the JAX package's
``make_optimizer(accum_iter=k)`` (``optax.MultiSteps`` around the
frozen-encoder AdamW) and ``make_finetune_step``, in fp32, tiny widths at
a 64x64 window, the same weights and batches, JAX's loss masks fed to the
port's ``finetune_core`` (as tests/test_torch_train.py does).

Six mini-steps at ``accum_iter`` 2 and 3, a new batch and shot at each,
one warmup epoch of two updates (so the learning rate of an update is
the schedule at the count of updates, not of mini-steps: 0 at the first
update). After every mini-step:

- the losses agree within 2e-6 relative;
- the counters: JAX's ``mini_step`` and ``gradient_step`` against the
  port's ``step % k`` and ``updates``;
- the accumulator (the running mean of the cycle's gradients, zero after
  an update) and Adam's two moments within 5e-6 of the largest |value|
  of their kind over all tensors, and each parameter within
  5e-6 * max(1, its tensor's largest |value|);
- on a mini-step that does not update, the port's parameters and moments
  keep their bits, and JAX's parameters their values.

Both sides run the same fp32 arithmetic and differ in the order of sums.
Elements whose exact gradient is 0 hold fp32 noise on both sides (the
exemplar convs' biases, every attention's key bias: see
``zero_grad_elements``; and any gradient below 1e-7 in some mini-step):
their moments are left out, and their parameters are held to Adam's step
bound, 2 lr per update, as in tests/test_torch_train.py. Observed: loss
rel. 6.8e-7; accumulator 2.1e-6, first moment 5.9e-7, second 6.9e-7;
parameters 8.7e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from countr_tpu.config import TrainConfig as JaxTrainConfig
from countr_tpu.engine import train as jtrain
from countr_tpu_torch.config import TrainConfig
from countr_tpu_torch.engine import train as ttrain
from countr_tpu_torch.models import build_countr
from tests.test_torch_train import (
    B, WEAK_GRAD, batch, bridge, jax_mask, jax_params, port_model, to_torch,
    zero_grad_elements,
)
from tests.torch_port_helpers import TINY

SHOTS = [3, 0, 2, 3, 2, 0]
LR = 1e-3
LOSS_REL = 2e-6
STATE_REL = 5e-6  # of the largest |value| of the kind (parameters: of max(1, it))


def _tree(tree_or_masked, params):
    """A params-shaped JAX tree (MaskedNode where frozen) -> the port's
    state_dict names, zeros for the masked leaves."""
    masked = lambda m: isinstance(m, optax.MaskedNode)  # noqa: E731
    return bridge(jax.tree.map(
        lambda m, x: np.zeros(np.shape(x), np.float32) if masked(m) else np.asarray(m),
        tree_or_masked, params, is_leaf=masked))


class AccumPair:
    """The same model, optimizer and accumulation in both packages."""

    def __init__(self, k: int):
        self.jm, params = jax_params("fp32", seed=0)
        kw = dict(batch_size=B, epochs=4, warmup_epochs=1, lr=LR, weight_decay=0.05,
                  accum_iter=k)
        tx, _ = jtrain.make_optimizer(JaxTrainConfig(**kw), steps_per_epoch=2,
                                      world_batch=B, freeze_encoder=True)
        self.jstate = jtrain.init_train_state(params["params"], tx)
        self.jstep = jtrain.make_finetune_step(self.jm, JaxTrainConfig(**kw))
        self.tm = port_model(params)
        self.tstate = ttrain.init_train_state(self.tm, TrainConfig(**kw), steps_per_epoch=2,
                                              world_batch=B)
        self.names = {id(p): n for n, p in self.tm.named_parameters()}
        self.weak = {}

    def step(self, i: int):
        key = jax.random.key(10 + i)
        b = batch(20 + i)
        self.jstate, jm = self.jstep(self.jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                     key, SHOTS[i])
        tb = to_torch(b)
        tm = ttrain.finetune_core(self.tstate, tb["image"], tb["gt_density"], tb["boxes"],
                                  SHOTS[i], torch.from_numpy(np.array(jax_mask(key))))
        for p, g in zip(self.tstate.params, self.tstate.grads):
            name = self.names[id(p)]
            a = g.abs().numpy()
            weak = (a > 0) & (a < WEAK_GRAD) | zero_grad_elements(name, a.shape)
            self.weak[name] = self.weak.get(name, weak) | weak
        return float(jm["loss"]), float(tm["loss"])

    def port_tensors(self, which: str) -> dict:
        """{name: tensor} of the port's ``acc``, ``exp_avg`` or ``exp_avg_sq``."""
        st = self.tstate
        if which == "acc":
            return {self.names[id(p)]: a for p, a in zip(st.params, st.acc)}
        return {self.names[id(p)]: st.optimizer.state[p][which] for p in st.params}


def _assert_close(got: dict, want: dict, weak: dict, what: str) -> None:
    """Every element of ``got`` within STATE_REL of the largest |value| in
    all of ``want`` (one scale for all the tensors of a kind: a tensor
    whose gradient is nearly 0 differs by the noise of the others' sums),
    noise elements left out."""
    keep = {n: ~weak.get(n, np.zeros(np.shape(want[n]), bool)) for n in got}
    top = max(np.abs(want[n])[keep[n]].max(initial=0.0) for n in got)
    for name, g in got.items():
        d = np.abs(g.detach().numpy() - want[name])[keep[name]].max(initial=0.0)
        assert d <= STATE_REL * top, (what, name, d, top)


@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_multisteps(k):
    pair = AccumPair(k)
    st = pair.tstate
    assert [st.schedule(u) for u in (0, 1)] == [0.0, LR / 2]
    for i in range(len(SHOTS)):
        before = {n: p.detach().clone() for n, p in pair.tm.named_parameters()}
        moments = {w: {n: t.clone() for n, t in pair.port_tensors(w).items()}
                   for w in ("exp_avg", "exp_avg_sq")}
        jbefore = bridge(pair.jstate.params)
        jl, tl = pair.step(i)
        assert tl == pytest.approx(jl, rel=LOSS_REL), i

        ms = pair.jstate.opt_state
        assert int(ms.mini_step) == st.step % k == (i + 1) % k, i
        assert int(ms.gradient_step) == st.updates == (i + 1) // k, i
        updated = (i + 1) % k == 0
        if not updated:
            for n, p in pair.tm.named_parameters():
                assert torch.equal(p.detach(), before[n]), (i, n)
            for w, saved in moments.items():
                for n, t in pair.port_tensors(w).items():
                    assert torch.equal(t, saved[n]), (i, w, n)
            jafter = bridge(pair.jstate.params)
            for n, v in jafter.items():
                np.testing.assert_array_equal(v, jbefore[n], err_msg=n)

        params = pair.jstate.params
        _assert_close(pair.port_tensors("acc"), _tree(ms.acc_grads, params), pair.weak, "acc")
        if updated:
            assert all(not a.any() for a in st.acc)
        inner = ms.inner_opt_state
        for ours, theirs in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            _assert_close(pair.port_tensors(ours),
                          _tree(optax.tree_utils.tree_get(inner, theirs), params),
                          pair.weak, ours)
        want = bridge(params)
        for name, p in pair.tm.named_parameters():
            d = np.abs(p.detach().numpy() - want[name])
            weak = pair.weak.get(name, np.zeros(d.shape, bool))
            top = max(1.0, np.abs(want[name]).max())
            assert d[~weak].max(initial=0.0) <= STATE_REL * top, (i, name)
            assert d[weak].max(initial=0.0) <= 2 * LR * st.updates, (i, name)
    assert st.step == len(SHOTS) and st.updates == len(SHOTS) // k


def test_accumulator_is_one_flat_buffer():
    """At ``accum_iter`` 2 every ``acc[i]`` is a view of one flat fp32
    buffer laid out as the gradients' (``segments``), which ``mutable``
    lists once, with no tensor per parameter; the fold on the two flat
    buffers gives the bits of MultiSteps' per-tensor fold."""
    model = build_countr(device="cpu", seed=0, training=True, **TINY)
    st = ttrain.init_train_state(model, TrainConfig(batch_size=B, accum_iter=2), 2, B)
    storage = {a.untyped_storage().data_ptr() for a in st.acc}
    assert len(st.acc) == len(st.params) > 1 and len(storage) == 1
    assert [a.shape for a in st.acc] == [p.shape for p in st.params]
    assert [a.storage_offset() for a in st.acc] == [g.storage_offset() for g in st.grads]
    held = [t for t in st.mutable() if t.untyped_storage().data_ptr() in storage]
    assert len(held) == 1 and held[0].shape == (st.segments.length,)
    assert not any(t is a for t in st.mutable() for a in st.acc)

    gen = torch.Generator().manual_seed(0)
    acc = [torch.zeros_like(p) for p in st.params]
    for update in (False, True):
        assert st.begin_step() == update
        want = []
        for g, a in zip(st.grads, acc):
            g.normal_(generator=gen)
            g = (g - a) / st.divisor
            want.append((g + a, torch.zeros_like(a)) if update else (g, a + g))
        st.apply_gradients(update)
        st.end_step(update)
        for (g, a), got_g, got_a in zip(want, st.grads, st.acc, strict=True):
            assert torch.equal(got_g, g) and torch.equal(got_a, a)
        acc = [a for _, a in want]
