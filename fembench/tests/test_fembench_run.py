"""One run end to end on the CPU at a tiny size (the harness's look for a
card skipped), the result line's keys, the refusal without a card, and
the faults that must turn ``correct`` false."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fembench import harness

ROOT = Path(__file__).resolve().parents[2]
TINY = {"block3d.solves": {"grid": [9, 5, 5]},
        "cantilever2d.topo": {"grid": [33, 17]}}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(cell, trace=0, seconds=0.5, seed=2 ** 31 + 7):
    bench = harness.load_benchmark()
    return harness.run_cell(bench, cell, seed, seconds, trace,
                            torch.device("cpu"), 0.0,
                            config_override=TINY[cell])


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contract_keys(cell, trace):
    r = run(cell, trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == want                     # checks come last
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    bench = harness.load_benchmark()
    cell_e = harness.by_name(bench["workloads"], cell, "workload")
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"]
               for m in harness.cell_metrics(bench, cell_e, kind)}
    for name, m in r["metrics"].items():
        assert allowed[name] == m["unit"]
    if not trace:                               # every end-to-end metric
        assert set(r["metrics"]) == set(allowed)
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_no_card_means_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "fembench.run", "--workload",
         "block3d.solves", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def broken_solve(monkeypatch, how):
    import pyfem_gpu_testflight_tpu_torch as pt

    real = pt.LinearElasticity.solve
    seen = []

    def solve(self, *a, **kw):
        u = real(self, *a, **kw)
        seen.append(u.clone())
        if how == "unchanged":                  # the answer never moves
            return torch.zeros_like(u)
        if how == "stale" and len(seen) > 1:    # the previous design's
            return seen[-2]
        if how == "altered":                    # one dof's answer altered
            u = u.clone()
            u[u.abs().argmax()] *= 1.01
        return u

    monkeypatch.setattr(pt.LinearElasticity, "solve", solve)


@pytest.mark.parametrize("how", ["unchanged", "stale", "altered"])
def test_a_broken_solve_is_not_correct(monkeypatch, how):
    broken_solve(monkeypatch, how)
    assert run("block3d.solves")["correct"] is False


@pytest.mark.parametrize("how", ["unchanged", "sensitivity"])
def test_a_broken_optimizer_is_not_correct(monkeypatch, how):
    from pyfem_gpu_testflight_tpu_torch.opt import topo_device

    real = topo_device.device_update_body

    def update(x, xold1, xold2, low, upp, g, *a, **kw):
        if how == "sensitivity":                # the gradient's sign altered
            g = -g
        out = real(x, xold1, xold2, low, upp, g, *a, **kw)
        if how == "unchanged":                  # the design never moves
            return (x,) + tuple(out[1:])
        return out

    monkeypatch.setattr(topo_device, "device_update_body", update)
    assert run("cantilever2d.topo")["correct"] is False


def test_benchmark_alone_gives_no_result(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's folder alone (no
    program) exits non-zero and prints no result line."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "fembench", tmp_path / "fembench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "-m", "fembench.run", "--workload",
         "block3d.solves", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
