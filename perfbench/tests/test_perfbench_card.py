"""Each cell of BENCHMARK.json run on the card for a few seconds, by the
command the benchmark gives, ends correct (skips without a card):

    python -m pytest -m cuda perfbench/tests/test_perfbench_card.py
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench_tiny import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port "
                    "on one")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_is_correct(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", "4100000001", "--seconds", "3", "--trace", trace],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]
