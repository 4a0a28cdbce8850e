"""The port's data parallelism (countr_tpu_torch/parallel, the data-parallel
TrainState of countr_tpu_torch/engine/train.py and the sharded
DevicePipeline) on the CPU.

- Two gloo ranks started once (tests/torch_dist_worker.py, torchrun's
  environment), each on its rows of one global batch, against one process
  on the whole batch (``engine_checks``, tiny fp32 builds at a 64 window):
  ``global_any`` sees the other rank's flag; one finetune step's averaged
  gradient within rel 1e-6 of the global batch's (max|d| over max|g|);
  the averaged metrics and the summed eval sums, two ``--device_aug``
  steps, four mini-steps at ``accum_iter`` 2 and two pretrain steps (the
  masking noise drawn in the step): the losses within rel 1e-5, the
  parameters after within 1e-5 but where an update's gradient was fp32
  noise (tests/test_torch_train.py's rule: Adam turns the noise into a
  step of up to lr either way, so those elements, ~0.03% here, are held
  to 2 lr per update); each rank's rows of a photometric draw equal to
  those rows of one draw, bit for bit. The two sides differ only in the
  order of the sums.
- In one process: ``get_mesh``, ``rows_of``; ``count_batch`` through a
  pipeline over [cpu, cpu] against the one-device pipeline (within 1e-6)
  and against the JAX package's ``count_batch`` on a 2-device mesh of
  the virtual CPU devices (within 1e-5); a ``batch_windows`` that the
  device count does not divide raises (JAX warns and runs on one device);
  ``cli.test --n_devices 2`` against one device (within 1e-6).
"""

import numpy as np
import pytest
import torch

from countr_tpu_torch.parallel.mesh import Mesh, get_mesh, global_any, rows_of
from tests import torch_dist_worker as worker
from tests.test_torch_cli import tiny_preset, tree  # noqa: F401  (fixtures)

GRAD_REL = 1e-6
REL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.run_ranks({"kind": "engine"}, 2, tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def single():
    return worker.engine_checks()


def test_global_any_sees_the_other_rank(ranks):
    assert ranks["any"].tolist() == [True, False]
    assert global_any(np.array([0, 1]), None) and not global_any([0, 0], None)


def test_averaged_gradient_is_the_global_batch_gradient(ranks, single):
    got, want = ranks["ft_grads"], single["ft_grads"]
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= GRAD_REL * np.abs(want).max()


@pytest.mark.parametrize("key", ["ft_metrics", "eval_sums", "aug_losses", "accum_losses",
                                 "pt_losses"])
def test_two_ranks_equal_one_process(ranks, single, key):
    got, want = ranks[key], single[key]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=REL)
    if key == "eval_sums":
        assert want[3] == 3.0  # the padding sample counts on neither side


@pytest.mark.parametrize("name", ["aug", "accum", "pt"])
def test_two_ranks_weights_equal_one_process(ranks, single, name):
    got, want, weak = ranks[f"{name}_params"], single[f"{name}_params"], single[f"{name}_weak"]
    d = np.abs(got - want)
    assert d[~weak].max() <= REL, d[~weak].max()
    assert d[weak].max(initial=0.0) <= 2 * worker.LR * single[f"{name}_updates"]
    assert weak.mean() < 0.03 and int(ranks[f"{name}_updates"]) == int(single[f"{name}_updates"])


def test_rank_rows_of_a_global_draw(ranks, single):
    """Rank 0's draw at its local batch is rows 0-1 of the global draw."""
    for k in ("noise", "factors", "perm", "sigma"):
        got, want = ranks[f"draw_{k}"], single[f"draw_{k}"]
        assert got.shape[0] == worker.B // 2
        np.testing.assert_array_equal(got, want[:worker.B // 2])


def test_get_mesh_and_rows():
    assert get_mesh(0, "cpu").devices == (torch.device("cpu"),)
    m = get_mesh(3, "cpu")
    assert len(m.devices) == 3 and (m.rank, m.world, m.group) == (0, 1, None)
    assert m.device == torch.device("cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        get_mesh(torch.cuda.device_count() + 1, "cuda")
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(rows_of(x, 1, 3), x[2:4])
    assert rows_of(x, 0, 1) is x
    assert Mesh(devices=(torch.device("cpu"),)).world == 1


# ---------------------------------------------------------------------------
# count_batch over two devices
# ---------------------------------------------------------------------------

COUNT_CASES = ("mixed_uint8", "zero_shot")


@pytest.fixture(scope="module")
def engines():
    from countr_tpu.engine.inference import CountingEngine as JaxEngine
    from countr_tpu.parallel.mesh import get_mesh as jax_mesh
    from countr_tpu_torch.engine.inference import CountingEngine
    from tests.torch_engine_cases import SMALL
    from tests.torch_port_helpers import jax_model, torch_model

    model, params = jax_model(seed=4, jit=True, **SMALL)
    tmodel = torch_model(params, **SMALL)
    return (CountingEngine(tmodel, batch_windows=4, device="cpu"),
            CountingEngine(tmodel, batch_windows=4, device="cpu", devices=["cpu", "cpu"]),
            JaxEngine(model, params, batch_windows=4, mesh=jax_mesh(2)))


@pytest.mark.parametrize("name", COUNT_CASES)
def test_two_device_count_batch(engines, name):
    from tests.test_torch_count_batch import batch

    one, two, jax_two = engines
    assert len(two._pipeline.replicas) == 2
    assert two._pipeline.replicas[1] is not one.model
    imgs, boxes, rects, shot, dens = batch(name)
    got = two.count_batch(imgs, boxes, rects, shot, return_density=dens)
    ref = one.count_batch(imgs, boxes, rects, shot, return_density=dens)
    want = jax_two.count_batch(imgs, boxes, rects, shot, return_density=dens)
    for i, (g, r, w) in enumerate(zip(got, ref, want, strict=True)):
        assert g.grid_mode == r.grid_mode == w.grid_mode, i
        assert g.n_windows == r.n_windows == w.n_windows, i
        for field in ("count", "raw_count", "e_cnt"):
            x = getattr(g, field)
            assert x == pytest.approx(getattr(r, field), rel=1e-6, abs=1e-6), (i, field)
            assert x == pytest.approx(getattr(w, field), rel=REL, abs=REL), (i, field)


def test_undivided_batch_windows_raises():
    from countr_tpu_torch.engine.device_pipeline import DevicePipeline, forward_buckets

    model = torch.nn.Linear(1, 1)
    with pytest.raises(ValueError, match="batch_windows 6 is not a multiple of the 4"):
        DevicePipeline(model, torch.device("cpu"), ["cpu"] * 4, batch_windows=6)
    with pytest.raises(ValueError, match="lead device"):
        DevicePipeline(model, torch.device("cpu"), ["cuda:0", "cpu"], batch_windows=4)
    assert forward_buckets(16, 3) == [16] and forward_buckets(16, 2) == [4, 8, 16]



def test_cli_test_over_two_devices(tree, tmp_path):  # noqa: F811
    """``cli.test --n_devices 2`` (the engine's window chunks split over
    [cpu, cpu]) against one device, on tests/test_torch_cli.py's tree, the
    tiny preset at random weights."""
    from countr_tpu_torch.cli import common
    from countr_tpu_torch.cli import test as ttest
    from tests.test_torch_cli import cli_argv

    def args(*extra):
        return ttest.get_args([*cli_argv(tree, "", str(tmp_path / f"o{len(extra)}"), *extra),
                               "--device", "cpu"])

    assert len(common.build_engine(args("--n_devices", "2"), True)._pipeline.devices) == 2
    one, two = ttest.main(args()), ttest.main(args("--n_devices", "2"))
    for k in ("MAE", "RMSE", "NAE"):
        assert two[k] == pytest.approx(one[k], rel=1e-6), k
