"""The control, the reference put in the program's place with its
element data computed in bfloat16, comes out not correct under each
cell's limits, while the program's own answers pass: at a size a CPU
test run can hold (the limits' readings come from the card at the cells'
own sizes, PERF.md)."""

import pytest
import torch

from fembench import check, harness, loops, program
from fembench.entries import solves, topo

TINY = {"cantilever2d": [65, 33], "block3d": [17, 9, 9]}


def setup(cell):
    bench = harness.load_benchmark()
    w = harness.by_name(bench["workloads"], cell, "workload")
    cfg = harness.load_config(bench, w["config"])
    cfg["grid"] = TINY[w["config"]]
    return cfg, harness.load_mix(w["traffic"]), check.load_limits(cell)


def test_solve_control_fails_and_program_passes():
    cfg, mix, limits = setup("block3d.solves")
    designs = loops.smooth_densities(cfg["grid"], 3, mix["design_seed"],
                                     mix["rho_min"], mix["rho_max"],
                                     mix["waves"], "cpu")
    model, _ = program.build_model(cfg, "cpu")
    solve = program.solver(model, cfg)
    items = [[d, d, solve(rho)] for d, rho in enumerate(designs)]
    ok, _ = check.judge(solves.judge(cfg, items, designs, list(limits),
                                     "cpu"), limits)
    assert ok
    ctrl = solves.control(cfg, designs, [0, 1, 2], list(limits), "cpu")
    ok, rows = check.judge(ctrl, limits)
    assert not ok, rows


def test_topo_control_fails_and_program_passes():
    cfg, mix, limits = setup("cantilever2d.topo")
    dt, run_cycle = topo.build(cfg, mix, "cpu")
    hist = run_cycle()
    state = tuple(dt.state)
    ok, rows = check.judge(topo.judge(cfg, state, hist, list(limits), "cpu"),
                           limits)
    assert ok, rows
    ctrl = topo.judge(cfg, state, hist, list(limits), "cpu",
                      lowp=torch.bfloat16)
    ok, rows = check.judge(ctrl, limits)
    assert not ok, rows
