"""Each cell's check against its faults: a run of the cell's driver, past
the harness's look for a card (on the CPU, at a tiny size, the program's
plain build), with the timed path broken underneath, has to come out
not correct; the same run unbroken has to come out correct.

Faults, as each cell can have them: an answer altered where it is
produced (one window's density in each window batch: the counting
cells), half of the batch left out with the mean taken over the rest
(every window batch's second half given the first half's densities; the
training loss over half the batch), a step that returns its state
unchanged (AdamW's update skipped: the training cell), and the training
cell's data path drawing crops outside RandomResizedCrop's range or
repeating one image through a batch. The exchange between chips is not a
fault any cell can have: every cell runs on one chip; nor does a
training cell produce tokens or answers."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.lib import common  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

SEED = 2**31 + 4242


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _driver(name):
    return common.load_module(common.BENCH / "drivers" / f"{name}.py", f"fault_{name}")


def _correct(out) -> bool:
    return not out.faults and all(c.ok for c in out.checks)


def _alter_one_window(monkeypatch):
    from countr_tpu_torch.models.countr import CounTR

    orig = CounTR.forward_tokens

    def altered(self, imgs, y):
        den = orig(self, imgs, y)
        return torch.cat([den[:1] * 1.5, den[1:]])

    monkeypatch.setattr(CounTR, "forward_tokens", altered)


def _half_batch(monkeypatch):
    from countr_tpu_torch.models.countr import CounTR

    orig = CounTR.forward_tokens

    def half(self, imgs, y):
        h = max(1, imgs.shape[0] // 2)
        den = orig(self, imgs[:h], y[:h])
        return torch.cat([den, den[: imgs.shape[0] - h]])

    monkeypatch.setattr(CounTR, "forward_tokens", half)


COUNT_FAULTS = {"none": None, "answer_altered": _alter_one_window, "half_batch": _half_batch}


@pytest.mark.parametrize("fault", list(COUNT_FAULTS))
def test_count_fewshot_faults(fault, monkeypatch):
    if COUNT_FAULTS[fault]:
        COUNT_FAULTS[fault](monkeypatch)
    t = tiny.traffic("fsc147_fewshot")
    out = _driver("count").run(tiny.context("count-fewshot", tiny.countr_config(), t, SEED, 1.0))
    assert _correct(out) == (fault == "none"), [(c.name, c.value, c.limit) for c in out.checks]


def _state_unchanged(monkeypatch):
    from countr_tpu_torch.engine.train import TrainState

    monkeypatch.setattr(TrainState, "apply_gradients", lambda self, update: None)


def _half_loss(monkeypatch):
    from countr_tpu_torch.models.mae import MaskedAutoencoderViT

    orig = MaskedAutoencoderViT.loss

    def half(self, imgs, pred, mask):
        h = max(1, imgs.shape[0] // 2)
        return orig(self, imgs[:h], pred[:h], mask[:h])

    monkeypatch.setattr(MaskedAutoencoderViT, "loss", half)


def _crops_outside_range(monkeypatch):
    from countr_tpu_torch.data.fsc147 import PretrainDataset

    # a tenth of the image's area: under RandomResizedCrop's scale of 0.2
    monkeypatch.setattr(PretrainDataset, "sample_crop",
                        staticmethod(lambda rng, h0, w0: (0, 0, h0 // 3, w0 // 3)))


def _images_repeated(monkeypatch):
    from countr_tpu_torch.data.loader import DataLoader

    orig = DataLoader.batches

    def repeated(self, epoch=0):
        return [b[:1].repeat(len(b)) for b in orig(self, epoch)]

    monkeypatch.setattr(DataLoader, "batches", repeated)


PRETRAIN_FAULTS = {"none": None, "state_unchanged": _state_unchanged, "half_batch": _half_loss,
                   "crops_outside_range": _crops_outside_range,
                   "images_repeated": _images_repeated}


@pytest.mark.parametrize("fault", list(PRETRAIN_FAULTS))
def test_pretrain_resident_faults(fault, monkeypatch):
    if PRETRAIN_FAULTS[fault]:
        PRETRAIN_FAULTS[fault](monkeypatch)
    t = tiny.traffic("pretrain_resident")
    out = _driver("pretrain").run(tiny.context("pretrain-resident", tiny.mae_config(), t, SEED,
                                               1.0))
    assert _correct(out) == (fault == "none"), [(c.name, c.value, c.limit) for c in out.checks]
