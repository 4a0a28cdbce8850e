"""The controls on the card: for every cell, the plain reference in
float8 put in the program's place fails at least one of the cell's
numbers, at the cell's own size, on three seeds. Skips without a card.

    python -m pytest benchmark/tests/test_control.py -q
"""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import common  # noqa: E402

CELLS = [w["name"] for w in common.load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the controls run on the card at the cells' own sizes")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, card):
    import json

    out = subprocess.run([sys.executable, str(ROOT / "benchmark/tests/control.py"), cell,
                          "11", "2147483659", "4294967311"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert len(lines) == 3
    for rec in lines:
        assert rec["fails"], rec
