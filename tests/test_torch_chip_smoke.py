"""chip_smoke.py loaded by path on the CPU, as scripts/profile_torch_*.py
load it: the helpers those scripts take from it are there without a
card, and its kernels' bounds are the benchmark's (benchmark/lib/peaks.py
and benchmark/work/kernels/*.py), so the smoke's kernel table and the
ledger's rooflines read one source."""

import importlib.util
from pathlib import Path

from benchmark.lib import peaks
from benchmark.work.kernels import b1, b2

ROOT = Path(__file__).resolve().parent.parent


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_by_path_has_the_scripts_helpers_and_the_benchmarks_bounds():
    smoke = load_smoke()
    for name in ("events_ms", "smi_line", "bound", "graph_ms", "profile_run", "randn_on",
                 "max_abs"):
        assert callable(getattr(smoke, name)), name
    # B1 at the counting path's [9216, 768] is bound by its bytes, B2 at
    # [16, 576, 768] by its operations
    for kernel, shape, bound_by in ((b1, (9216, 768), "bytes"),
                                    (b2, (16, 576, 768), "operations")):
        flops, nbytes = kernel.flops(*shape), kernel.nbytes(*shape)
        assert smoke.bound(flops, nbytes) == (peaks.least_seconds(flops, nbytes) * 1e3,
                                              bound_by)
