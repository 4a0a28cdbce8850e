"""The port's finetune engine (countr_tpu_torch/engine/train.py) against
the JAX package's (countr_tpu/engine/train.py) in fp32, the kernels off
on both sides, from the same weights (state_dict_from_flax) and inputs
(numpy), tiny widths at a 64x64 window.

- One step of ``make_finetune_step`` (JAX) and ``finetune_core`` (port)
  fed JAX's loss mask: the loss, the metrics, every trainable gradient
  (the port's ``.grad`` against JAX's, read from its first Adam moment,
  mu = (1 - b1) * g, and mapped through the same bridge) and the
  parameters after the update. Shot 0 and 3; at shot 0 the shot token's
  gradient is checked with the rest.
- Three steps: the parameters after each, with the learning rate
  nonzero from step 0, and with step 0 inside the warmup (lr 0).
- The frozen encoder: unchanged, no optimizer state, no gradient.
- The schedule, the decay and frozen groups, the eval step and the
  encoder transfer against their JAX counterparts.

Tolerances: parameters, loss and metrics 1e-5 (relative for the loss
and metrics); gradients 1e-5 * max(1, max|g|). Both sides run the same
fp32 arithmetic (JAX at Precision.HIGHEST) and differ in the order of
sums. The exception: parameter elements whose gradient is fp32 noise
(the exact gradient is 0: the exemplar convs' biases, which an
affine-free InstanceNorm follows, and every attention's key bias, which
the softmax removes; or it falls below 1e-7 but is not 0), where Adam
turns the noise into an update of up to lr, are held to Adam's step
bound: 1-3% of the elements. Observed: gradients max|d| 4.2e-7; loss
rel. 4.7e-7; parameters over three steps 3.2e-6 (the rest), 8.3e-4
(those).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from countr_tpu.config import CounTRConfig as JaxConfig
from countr_tpu.config import TrainConfig as JaxTrainConfig
from countr_tpu.engine import schedule as jschedule
from countr_tpu.engine import train as jtrain
from countr_tpu.models.countr import CounTR as JaxCounTR
from countr_tpu_torch.config import CounTRConfig as TorchConfig
from countr_tpu_torch.config import TrainConfig
from countr_tpu_torch.engine import train as ttrain
from countr_tpu_torch.engine.checkpoint import load_weights, state_dict_from_flax
from countr_tpu_torch.engine.schedule import warmup_cosine
from countr_tpu_torch.models.countr import CounTR as TorchCounTR
from tests.torch_port_helpers import BF16_FAST, TINY

HW = 64
TRAIN_TINY = {**TINY, "img_size": HW}
B = 2
WEAK_GRAD = 1e-7  # see _assert_params_match


def jax_params(mode="fp32", seed=0, **kw):
    """(model, params) of a tiny JAX CounTR at a 64 window, the training
    build of ``mode``; params randomised beyond the init."""
    dt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    extra = {**BF16_FAST, "fused_attn_block": False} if mode == "bf16" else {}
    model = JaxCounTR(JaxConfig(**{**TRAIN_TINY, **kw, **extra, "dtype": dt}))
    params = jax.jit(model.init, static_argnums=3)(
        jax.random.key(seed), jnp.zeros((1, HW, HW, 3)), jnp.zeros((1, 3, 64, 64, 3)), 3)
    rng = np.random.default_rng(seed + 100)
    leaves, tree = jax.tree.flatten(params)
    leaves = [np.asarray(l) + 0.02 * rng.standard_normal(np.shape(l)).astype(np.float32)
              for l in leaves]
    return model, jax.tree.unflatten(tree, [jnp.asarray(l) for l in leaves])


def bridge(tree) -> dict:
    """A CounTR-shaped numpy tree -> the port's state_dict names."""
    return state_dict_from_flax(jax.tree.map(np.asarray, tree), grid=HW // 16)


def port_model(params, mode="fp32", **kw) -> TorchCounTR:
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    extra = {**BF16_FAST, "fused_attn_block": False} if mode == "bf16" else {}
    model = TorchCounTR(TorchConfig(**{**TRAIN_TINY, **kw, **extra, "dtype": dt}))
    load_weights(model, bridge(params))
    return model.train()


def batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.uniform(0, 1, (B, HW, HW, 3)).astype(np.float32),
        "gt_density": (0.05 * rng.uniform(0, 1, (B, HW, HW))).astype(np.float32),
        "boxes": rng.uniform(0, 1, (B, 3, 64, 64, 3)).astype(np.float32),
    }


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def jax_mask(key):
    return np.asarray(jax.random.bernoulli(key, 0.8, (HW, HW)))


def train_cfgs(warmup_epochs):
    kw = dict(batch_size=B, epochs=4, warmup_epochs=warmup_epochs, lr=1e-3,
              weight_decay=0.05)
    return JaxTrainConfig(**kw), TrainConfig(**kw)


class Pair:
    """The same model and optimizer in both packages, stepped together."""

    def __init__(self, shots, warmup_epochs=0, mode="fp32", seed=0):
        self.jm, params = jax_params(mode, seed)
        jcfg, tcfg = train_cfgs(warmup_epochs)
        tx, _ = jtrain.make_optimizer(jcfg, steps_per_epoch=2, world_batch=B,
                                      freeze_encoder=True)
        self.jstate = jtrain.init_train_state(params["params"], tx)
        self.jstep = jtrain.make_finetune_step(self.jm, jcfg)
        self.tm = port_model(params, mode)
        self.tstate = ttrain.init_train_state(self.tm, tcfg, steps_per_epoch=2, world_batch=B)
        self.shots = shots
        self.before = {k: v.detach().clone() for k, v in self.tm.state_dict().items()}
        self.weak = {}  # name -> elements whose gradient was below WEAK_GRAD

    def step(self, i, b):
        key = jax.random.key(10 + i)
        mask = torch.from_numpy(np.array(jax_mask(key)))
        self.jstate, jm = self.jstep(self.jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                     key, self.shots[i])
        tb = to_torch(b)
        tmets = ttrain.finetune_core(self.tstate, tb["image"], tb["gt_density"], tb["boxes"],
                                     self.shots[i], mask)
        for name, p in self.tm.named_parameters():
            if p.grad is not None:
                g = p.grad.abs().numpy()
                weak = (g > 0) & (g < WEAK_GRAD) | zero_grad_elements(name, g.shape)
                self.weak[name] = self.weak.get(name, weak) | weak
        return {k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in tmets.items()}



def zero_grad_elements(name: str, shape) -> np.ndarray:
    """Where the exact gradient is 0 whatever the data, so that each side
    holds only fp32 noise: the exemplar convs' biases (an affine-free
    InstanceNorm follows) and the key biases of every attention (they add
    one constant to a row of logits, which the softmax removes)."""
    mask = np.zeros(shape, bool)
    if name.startswith("decoder_proj") and name.endswith(".bias") or \
            name.endswith("attn.wk.bias"):
        mask[...] = True
    elif name.endswith("selfattn.qkv.bias"):
        c = TINY["decoder_embed_dim"]
        mask[c:2 * c] = True
    return mask


def _assert_params_match(pair, lr: float = 1e-3):
    """Every parameter element within 1e-5 of JAX's, except those whose
    gradient is fp32 noise (``pair.weak``: ``zero_grad_elements``, and
    any gradient that was nonzero but below WEAK_GRAD in some step):
    there Adam's update g / (|g| + 1e-8) turns the noise into a step of
    up to lr on either side, so they are held to Adam's step bound, 2 lr
    per step taken. (An exactly zero gradient, as the exemplar CNN's at
    zero shots, is the same on both sides and stays held to 1e-5.)"""
    want = bridge(pair.jstate.params)
    got = pair.tm.state_dict()
    for k, w in want.items():
        d = np.abs(got[k].numpy() - w)
        weak = pair.weak.get(k, np.zeros(d.shape, bool))
        assert d[~weak].max(initial=0.0) <= 1e-5, (k, d[~weak].max())
        assert d[weak].max(initial=0.0) <= 2 * lr * pair.tstate.step, k


@pytest.mark.parametrize("shot", [3, 0])
def test_one_step_matches_jax(shot):
    pair = Pair([shot])
    jm, tm = pair.step(0, batch())
    for k in ("loss", "mae", "mse"):
        assert tm[k] == pytest.approx(jm[k], rel=1e-5), k
    # JAX's gradients from its first Adam moment (mu = (1 - b1) * g)
    # (frozen leaves carry no moment: zeros there)
    masked = lambda m: isinstance(m, optax.MaskedNode)  # noqa: E731
    want = bridge(jax.tree.map(
        lambda m, x: np.zeros(np.shape(x)) if masked(m) else np.asarray(m, np.float64) / 0.1,
        optax.tree_utils.tree_get(pair.jstate.opt_state, "mu"), pair.jstate.params,
        is_leaf=masked))
    labels = ttrain.frozen_labels(pair.tm)
    checked = 0
    for name, p in pair.tm.named_parameters():
        if labels[name] == "frozen":
            assert p.grad is None, name
            continue
        g = p.grad.numpy()
        assert np.abs(g - want[name]).max() <= 1e-5 * max(1.0, np.abs(want[name]).max()), name
        checked += 1
    assert checked == 75
    if shot == 0:
        assert np.abs(pair.tm.shot_token.grad.numpy()).max() > 0
    _assert_params_match(pair)


@pytest.mark.parametrize("warmup_epochs", [0, 1], ids=["lr_from_step0", "warmup"])
def test_three_step_trajectory_matches_jax(warmup_epochs):
    pair = Pair([3, 0, 2], warmup_epochs=warmup_epochs)
    sched = pair.tstate.schedule
    assert (sched(0) == 0.0) == (warmup_epochs > 0)
    b = batch(1)
    for i in range(3):
        jm, tm = pair.step(i, b)
        assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-5), i
        _assert_params_match(pair)
    assert pair.tstate.step == 3
    # the frozen encoder: unchanged, no optimizer state
    labels = ttrain.frozen_labels(pair.tm)
    state = pair.tm.state_dict()
    for name, p in pair.tm.named_parameters():
        if labels[name] == "frozen":
            assert torch.equal(state[name], pair.before[name]), name
            assert not pair.tstate.optimizer.state.get(p), name
        else:
            assert pair.tstate.optimizer.state[p]["step"] == 3, name


def test_schedule_matches_jax():
    kw = dict(epochs=100, warmup_epochs=10, steps_per_epoch=50, min_lr=1e-6)
    js = jschedule.warmup_cosine(1e-3, **kw)
    ts = warmup_cosine(1e-3, **kw)
    for step in [0, 1, 250, 499, 500, 501, 2500, 4999, 5000]:
        assert ts(step) == pytest.approx(float(js(step)), rel=1e-5, abs=1e-10), step


def test_groups_match_jax():
    """decay_mask and frozen_labels against JAX's, through the bridge
    (labels as 0/1 arrays of each parameter's shape)."""
    jm, params = jax_params()
    p = params["params"]
    decay = bridge(jax.tree.map(lambda m, x: np.full(np.shape(x), m, np.float32),
                                jtrain.decay_mask(p), p))
    frozen = bridge(jax.tree.map(lambda lab, x: np.full(np.shape(x), lab == "frozen",
                                                        np.float32),
                                 jtrain.frozen_labels(p), p))
    tm = port_model(params)
    tdecay, tfrozen = ttrain.decay_mask(tm), ttrain.frozen_labels(tm)
    assert sorted(tdecay) == sorted(k for k in decay if "pos_embed" not in k)
    for name in tdecay:
        assert tdecay[name] == bool(decay[name].all()) == bool(decay[name].any()), name
        assert (tfrozen[name] == "frozen") == bool(frozen[name].all()), name
    # the optimizer's groups follow them
    opt, _ = ttrain.make_optimizer(tm, TrainConfig(), 10, B)
    ids = [{id(q) for q in g["params"]} for g in opt.param_groups]
    for name, q in tm.named_parameters():
        want = [] if tfrozen[name] == "frozen" else [0 if tdecay[name] else 1]
        assert [i for i, s in enumerate(ids) if id(q) in s] == want, name
    assert [g["weight_decay"] for g in opt.param_groups] == [0.05, 0.0]


@pytest.mark.parametrize("shot", [3, 0])
def test_eval_step_matches_jax(shot):
    jm, params = jax_params(seed=2)
    tm = port_model(params).eval()
    b = batch(2)
    b["valid"] = np.array([1.0, 0.0], np.float32)
    want = jtrain.make_eval_step(jm)(params["params"], {k: jnp.asarray(v) for k, v in b.items()},
                                     shot)
    got = ttrain.make_eval_step(tm)(to_torch(b), shot)
    for k in ("err_sum", "sq_sum", "nae_sum", "n"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5, abs=1e-7), k


def test_transfer_encoder_matches_jax():
    _, dst = jax_params(seed=3)
    _, src = jax_params(seed=4)  # stands in for the MAE tree: same encoder keys
    want = bridge(jtrain.transfer_encoder(src, dst, depth=TINY["depth"]))
    got = ttrain.transfer_encoder(bridge(src), bridge(dst), depth=TINY["depth"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    key = "blocks.0.attn.qkv.weight"
    assert not np.array_equal(got[key], bridge(dst)[key])
