"""On the card: each cell of ``BENCHMARK.json`` runs through the command
for a short window and comes out correct, and its control does not.
Run on a machine with a CUDA device:
``python -m pytest perfbench/tests/test_perfbench_card.py -q``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench.spec import ROOT, read_json

CELLS = [w["name"] for w in read_json(ROOT + "/BENCHMARK.json")["workloads"]]


def run_cell(cell: str, *extra: str) -> dict:
    p = subprocess.run(
        [sys.executable, "-m", "perfbench", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    res = run_cell(cell)
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(card, cell):
    assert not run_cell(cell, "--control", "1")["correct"]
