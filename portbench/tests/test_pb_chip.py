"""On the card: a short run of each cell is correct and its control is
not. Marked ``portbench_chip``; skips without a CUDA card. Run from the
root of the checkout on the chip: ``python -m pytest portbench/tests -q
-m portbench_chip``."""

import json
import os
import subprocess
import sys

import pytest

from portbench.catalog import REPO_ROOT


def _run(cell, seed, *extra):
    out = subprocess.run(
        [sys.executable, os.path.join("portbench", "run.py"), "--workload",
         cell, "--seed", str(seed), "--seconds", "2", "--trace", "0",
         *extra], cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.portbench_chip
@pytest.mark.parametrize("cell", ["plugin8_f64.stream",
                                  "plugin8_f64.live"])
def test_cell_and_its_control_on_the_card(cuda_card, cell):
    sound = _run(cell, 2 ** 31 + 7)
    assert sound["correct"], sound["check"]
    assert sound["device"]["platform"] == "gpu"
    # the live cell is held to its deadline; the stream has none
    assert ("late_pct" in sound["check"]) == cell.endswith(".live")
    # and reports the card's time a block, from a trace after the window
    assert ("card_ms_per_block" in sound["metrics"]) == cell.endswith(
        ".live")
    control = _run(cell, 2 ** 31 + 7, "--control")
    assert not control["correct"], control["check"]
