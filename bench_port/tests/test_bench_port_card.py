"""On the card: one short run of each cell through the benchmark's
command (``BENCHMARK.json``), and the result line it prints.  Skips
without a card."""

import json
import subprocess
import sys

import pytest
from conftest import BENCH, cells


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_a_cell_runs_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", cell, "--seed",
         "3000000005", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
