"""The port's device augmentation (countr_tpu_torch/ops/augment.py) against
the JAX package's (countr_tpu/ops/augment.py) on the CPU, both fed the
same factors: each colour op, the blur and the density synthesis within
1e-5 (fp32; the two differ in the order of a few sums); the density also
against scipy's gaussian_filter of the dot map; the branchless jitter in
all 24 op orders against JAX's sequential application of the same ops;
the draws in their ranges; and a tiny fp32 finetune step with
``device_aug`` equal, to the bit, to the host-fed step on the images and
densities it produced."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from countr_tpu.ops import augment as J
from countr_tpu_torch.ops import augment as A

TOL = 1e-5


def _imgs(seed=0, b=3, h=40, w=56):
    return np.random.default_rng(seed).uniform(0, 1, (b, h, w, 3)).astype(np.float32)


def _jax_each(fn, imgs, *per_sample):
    return np.stack([np.asarray(fn(jnp.asarray(imgs[i]), *(a[i] for a in per_sample)))
                     for i in range(imgs.shape[0])])


@pytest.mark.parametrize("op", ["brightness", "contrast", "saturation", "hue"])
def test_colour_ops(op):
    imgs = _imgs(1)
    rng = np.random.default_rng(2)
    f = (rng.uniform(-0.15, 0.15, 3) if op == "hue" else rng.uniform(0.75, 1.25, 3))
    f = f.astype(np.float32)
    want = _jax_each(getattr(J, f"_{op}"), imgs, f)
    got = getattr(A, op)(torch.from_numpy(imgs), torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_gaussian_blur():
    imgs = _imgs(3)
    sigma = np.asarray([0.1, 0.9, 2.0], np.float32)
    got = A.gaussian_blur(torch.from_numpy(imgs), torch.from_numpy(sigma)).numpy()
    np.testing.assert_allclose(got, _jax_each(J.gaussian_blur, imgs, sigma), atol=TOL, rtol=0)


def test_density_from_dots_against_jax_and_scipy():
    rng = np.random.default_rng(4)
    b, k, h, w = 3, 64, 48, 40
    dots = rng.integers(-3, 52, (b, k, 2)).astype(np.int16)  # some clamped, some repeated
    dots[0, 10:20] = dots[0, :10]
    n = np.asarray([64, 17, 0], np.int32)
    got = A.density_from_dots(torch.from_numpy(dots), torch.from_numpy(n), h, w).numpy()
    want = np.stack([np.asarray(J.density_from_dots(jnp.asarray(dots[i]), n[i], h, w))
                     for i in range(b)])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    for i in range(b):
        m = np.zeros((h, w), np.float32)
        d = dots[i, : n[i]].astype(np.int64)
        m[np.clip(d[:, 1], 0, h - 1), np.clip(d[:, 0], 0, w - 1)] = 1.0
        np.testing.assert_allclose(got[i], ndimage.gaussian_filter(m, sigma=1.0) * 60.0,
                                   atol=TOL, rtol=0)
    assert got[2].sum() == 0


@pytest.mark.parametrize("perm", list(itertools.permutations(range(4))))
def test_branchless_jitter_every_order(perm):
    """Each of the 24 orders, per sample, against JAX's ops applied one
    after another in that order with the same factors."""
    imgs = _imgs(5, b=2, h=24, w=32)
    factors = np.asarray([[1.2, 0.9, 1.1, 0.1], [0.8, 1.13, 0.87, -0.12]], np.float32)
    order = np.asarray([perm, perm[::-1]], np.int64)
    ops = (J._brightness, J._contrast, J._saturation, J._hue)
    want = []
    for i in range(2):
        x = jnp.asarray(imgs[i])
        for k in order[i]:
            x = ops[k](x, factors[i, k])
        want.append(np.asarray(x))
    got = A.color_jitter(torch.from_numpy(imgs), torch.from_numpy(factors),
                         torch.from_numpy(order)).numpy()
    np.testing.assert_allclose(got, np.stack(want), atol=TOL, rtol=0)


def test_draws_in_range():
    gen = torch.Generator().manual_seed(0)
    d = A.draw_photometric(512, 8, 8, gen)
    f, s = d["factors"].numpy(), d["sigma"].numpy()
    for k, (lo, hi) in enumerate([(0.75, 1.25), (0.85, 1.15), (0.85, 1.15), (-0.15, 0.15)]):
        assert lo <= f[:, k].min() and f[:, k].max() <= hi
        assert f[:, k].max() - f[:, k].min() > 0.9 * (hi - lo)  # the whole range is drawn
    assert 0.1 <= s.min() and s.max() <= 2.0
    assert sorted(map(tuple, np.sort(d["perm"].numpy(), 1))) == [(0, 1, 2, 3)] * 512
    assert len({tuple(p) for p in d["perm"].numpy()}) == 24
    noise = d["noise"].numpy()
    assert noise.shape == (512, 8, 8, 3) and abs(noise.std() - A.NOISE_STD) < 0.005
    # the same seed repeats the draws; photometric is a function of the draws
    again = A.draw_photometric(512, 8, 8, torch.Generator().manual_seed(0))
    assert all(torch.equal(d[k], again[k]) for k in d)


def test_augment_batch_mosaic_samples_stay_clean():
    rng = np.random.default_rng(6)
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8))
    dots = torch.zeros((2, 4, 2), dtype=torch.int16)
    imgs, gt = A.augment_batch(u8, dots, torch.tensor([0, 0], dtype=torch.int32),
                               torch.tensor([0.0, 1.0]), torch.Generator().manual_seed(1))
    assert torch.equal(imgs[0], u8[0].float() / 255.0)
    assert not torch.equal(imgs[1], u8[1].float() / 255.0)
    assert gt.shape == (2, 16, 16) and gt.sum() == 0


def test_device_aug_step_equals_host_fed_step():
    """A finetune step with ``device_aug`` against the host-fed step of a
    twin from the same weights, fed the images and densities the first
    one's augmentation produced and the same loss mask (the generator at
    the same state): the same loss and the same weights."""
    from countr_tpu_torch.config import TrainConfig
    from countr_tpu_torch.engine import train as engine
    from countr_tpu_torch.models import build_countr
    from tests.torch_port_helpers import TINY

    hw, b = 64, 2
    cfg = TrainConfig(batch_size=b, lr=1e-3, warmup_epochs=0)

    def setup(device_aug):
        model = build_countr("mae_vit_base6_patch16", device="cpu", seed=3, training=True,
                             **{**TINY, "img_size": hw})
        state = engine.init_train_state(model, cfg, steps_per_epoch=10, world_batch=b)
        gen = torch.Generator()
        return state, gen, engine.make_finetune_step(state, cfg, gen, device_aug=device_aug)

    rng = np.random.default_rng(7)
    batch = {"image_u8": torch.from_numpy(rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8)),
             "dots": torch.from_numpy(rng.integers(0, hw, (b, 32, 2)).astype(np.int16)),
             "n_dots": torch.tensor([32, 9], dtype=torch.int32),
             "apply_photo": torch.tensor([1.0, 0.0]),
             "boxes": torch.from_numpy(rng.uniform(0, 1, (b, 3, 64, 64, 3)).astype(np.float32))}
    sa, ga, step_a = setup(True)
    sh, gh, step_h = setup(False)
    for i, shot in enumerate((3, 1)):
        ga.manual_seed(10 + i)
        gh.manual_seed(10 + i)
        imgs, gt = A.augment_batch(*(batch[k] for k in engine.DEVICE_AUG_KEYS[:4]), gh)
        ma = step_a(batch, shot)
        mh = step_h({"image": imgs, "gt_density": gt, "boxes": batch["boxes"]}, shot)
        assert all(torch.equal(ma[k], mh[k]) for k in ma), (ma, mh)
        assert torch.equal(ga.get_state(), gh.get_state())
    for p, q in zip(sa.model.parameters(), sh.model.parameters()):
        assert torch.equal(p, q)
    assert float(ma["loss"]) > 0
