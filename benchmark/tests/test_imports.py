"""The import check: loading every driver, every reader and the reference
leaves no module of JAX, of its libraries or of the JAX package in the
process (top-level names compared whole: ``countr_tpu_torch`` is not
``countr_tpu``), and the reference loads nothing of the program."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

LOAD_ALL = """
import sys
sys.path.insert(0, {root!r})
from benchmark.lib import common
common.set_cache_env()
for sub in ("drivers", "metrics", "reference", "work/kernels", "work/models", "lib", "frozen"):
    for p in sorted((common.BENCH / sub).glob("*.py")):
        if p.name != "__init__.py":
            common.load_module(p, "probe_" + sub.replace("/", "_") + "_" + p.stem.replace(".", "_"))
import benchmark.drivers.count, benchmark.drivers.pretrain
# what the drivers load of the program when they run
import countr_tpu_torch.engine.inference, countr_tpu_torch.cli.pretrain
import countr_tpu_torch.data.transforms, countr_tpu_torch.data.loader, countr_tpu_torch.models
print("loaded:" + ",".join(common.forbidden_modules()))
"""

LOAD_REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.countr, benchmark.reference.mae, benchmark.reference.precision
print("loaded:" + ",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1].split("loaded:", 1)[1]


def test_no_jax_nor_the_jax_package_loaded():
    assert _run(LOAD_ALL) == ""


def test_reference_loads_nothing_of_the_program():
    tops = set(_run(LOAD_REFERENCE).split(","))
    assert "countr_tpu_torch" not in tops
    assert not tops & {"jax", "jaxlib", "flax", "optax", "countr_tpu"}


def test_forbidden_compares_whole_top_level_names():
    sys.path.insert(0, str(ROOT))
    from benchmark.lib.common import forbidden_modules

    assert forbidden_modules(["countr_tpu_torch", "countr_tpu_torch.models", "jaxtyping"]) == []
    assert forbidden_modules(["countr_tpu.models", "jax", "flax.linen"]) == [
        "countr_tpu.models", "flax.linen", "jax"]
