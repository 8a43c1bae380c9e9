"""The comparison's control and its planted faults on the card, at each
cell's own size, through ``vobench.control``: each must come out as not
correct under the cell's limits.  On the card's machine, from the root of
the checkout: ``python -m pytest vobench/tests -q -m cuda`` (each test
skips without a card, decided inside it)."""
import json
from pathlib import Path

import pytest

from vobench import cell as cellmod, control

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CONTROL_SEEDS = (5100000001, 5100000002, 5100000003)
CONTROL_SECONDS = 15.0
FAULT_SECONDS = 5.0

pytestmark = pytest.mark.cuda


@pytest.fixture
def card(monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    monkeypatch.chdir(ROOT)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_comes_out_not_correct(card, name):
    """TF32 matmuls, the precision below the configuration's float32, on
    three seeds."""
    lines = control.run_kind(cellmod.load(name, ROOT), "tf32", CONTROL_SEEDS,
                             CONTROL_SECONDS)
    assert [ln["correct"] for ln in lines] == [False] * len(CONTROL_SEEDS), \
        lines


@pytest.mark.parametrize("kind", ["frozen", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_comes_out_not_correct(card, name, kind):
    lines = control.run_kind(cellmod.load(name, ROOT), kind,
                             [5100000010], FAULT_SECONDS)
    assert lines[0]["correct"] is False, lines
