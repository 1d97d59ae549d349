"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program under test.  Each check runs in a
fresh interpreter; a module's top-level name is compared whole (the
port's name begins with the JAX package's)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = {"cantilever2d": [33, 17], "block3d": [9, 5, 5]}


def top_level_after(code):
    full = ("import sys\n" + code +
            "\nprint(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", full], cwd=ROOT, text=True,
                       capture_output=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(eval(p.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_a_cell_loads_no_jax(w):
    grid = TINY[w["config"]]
    mods = top_level_after(
        "import torch\n"
        "from fembench import harness, run, calibrate\n"
        "b = harness.load_benchmark()\n"
        f"harness.run_cell(b, {w['name']!r}, 3, 0.2, 1, torch.device('cpu'),"
        f" 0.0, config_override={{'grid': {grid!r}}})\n"
        "import glob, os\n"
        "for f in glob.glob('fembench/metrics/*.py'):\n"
        "    harness.load_reader(os.path.basename(f)[:-3])\n")
    assert "pyfem_gpu_testflight_tpu_torch" in mods      # the program ran
    assert not mods & {"jax", "jaxlib", "flax", "pyfem_gpu_testflight_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    mods = top_level_after(
        "from fembench.reference import elasticity, helmholtz, mma\n")
    assert not mods & {"pyfem_gpu_testflight_tpu_torch", "jax",
                       "pyfem_gpu_testflight_tpu"}
    for f in (ROOT / "fembench" / "reference").glob("*.py"):
        assert "pyfem_gpu_testflight_tpu" not in f.read_text(), f
