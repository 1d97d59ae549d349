"""Each cell once on the card, briefly (the card decides inside the test;
without one the test skips).  Run on the card with
``python -m pytest -m slow fembench/tests/test_fembench_card.py``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.slow
@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(w, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "-m", "fembench.run", "--workload", w["name"],
         "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
