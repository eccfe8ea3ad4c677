"""Rehearsals of each cell on the CPU at its configuration's tiny sizes
(``--dry``, through the port's plain paths): a sound run comes out correct
and prints no device metric; the timed path broken underneath, or the
control in the program's place, comes out not correct. Card-only checks of
the same skip without a card."""

import json
import subprocess
import sys
import time

import pytest

from portbench import calibrate
from portbench.harness import ROOT
from portbench.manifest import find_cell
from portbench.run import run_cell

CELLS = ("arxiv-train", "amazon2m-batch-train", "arxiv-serve")
SEED = 2 ** 31 + 977


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_is_correct_and_prints_no_device_metric(cell):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
                          str(SEED), "--seconds", "0.5", "--trace", "1", "--dry"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["dry"] and result["correct"], result
    assert "metrics" not in result and "device" not in result
    assert list(result)[-1] == "checks" and result["failed"] == 0
    assert out.stderr.strip().splitlines()[-1].startswith("check failed 0 limit 0")


def test_a_run_needs_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "arxiv-train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _dry(cell, hooks):
    return run_cell(find_cell(cell), SEED, 0.3, False, True, time.time(), hooks=hooks)


FAULTS = [(cell, fault) for cell, kind in (("arxiv-train", "full_graph_train"),
                                           ("amazon2m-batch-train", "batch_train"),
                                           ("arxiv-serve", "serve"))
          for fault in calibrate.FAULTS[kind]]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault):
    kind = find_cell(cell).traffic["kind"]
    target, plant = calibrate.FAULTS[kind][fault]
    result = _dry(cell, {target: plant})
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ("arxiv-train", "arxiv-serve"))
def test_the_fp8_control_is_not_correct(cell):
    c = find_cell(cell)
    numbers = calibrate.control_reading(c, SEED, 0.3, True)
    assert any(v > c.limits[k] for k, v in numbers.items()), numbers


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct_on_the_card(card):
    c = find_cell("amazon2m-batch-train")
    c.config = json.loads(json.dumps(c.config))
    c.config["graph"].update(c.config["dry"]["graph"])
    c.config["train"].update(c.config["dry"]["train"])
    numbers = calibrate.control_reading(c, SEED, 0.3, False)
    assert any(v > c.limits[k] for k, v in numbers.items()), numbers
