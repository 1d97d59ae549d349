"""Entry ``solves``: one caller re-solves a structured elasticity
cantilever under GMG for a stream of designs, cycling through the mix's
fixed set of smooth densities in an order drawn from the seed, each
solve assembling the hierarchy and solving from x = 0.  The sampled
answers are judged against the float64 reference's operator and solve.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import check, loops, program
from ..reference import elasticity as ref
from ..trace import Segment

F64 = torch.float64


def build(cfg, mix, device):
    """(model, timed call rho -> u, the design set) of a configuration."""
    model, _ = program.build_model(cfg, device)
    designs = loops.smooth_densities(
        cfg["grid"], mix["designs"], mix["design_seed"], mix["rho_min"],
        mix["rho_max"], mix["waves"], device,
        dtype=program.DTYPES[cfg["dtype"]])
    return model, program.solver(model, cfg), designs


def run(cfg, mix, seed, seconds, trace, device, t0, names):
    model, solve, designs = build(cfg, mix, device)
    order = loops.design_order(len(designs), seed)
    for j in range(mix["warmup"]):
        solve(designs[order[j % len(order)]])
    loops.sync(device)
    setup_s = time.perf_counter() - t0
    loops.reset_peak(device)
    win = loops.solve_window(solve, lambda: program.last_iters(model),
                             designs, order, seconds, device, mix["sample"],
                             seed, start=mix["warmup"])
    peak = loops.peak_bytes(device)
    times = np.asarray(win["times"])
    e2e = {
        "setup_s": (setup_s, "s"),
        "solve_ms": (1e3 * win["elapsed"] / max(1, len(times)), "ms"),
        "solve_p90_ms": (1e3 * float(np.percentile(times, 90))
                         if len(times) else float("nan"), "ms"),
        "peak_mem_gib": (peak / loops.GIB, "GiB"),
    }
    counters = {"iters": win["iters"], "trace_iters": []}
    seg = None
    if trace:
        with Segment(device) as seg:
            for j in range(mix["trace_units"]):
                with record_function("fembench.solve"):
                    solve(designs[order[(win["next"] + j) % len(order)]])
                counters["trace_iters"].append(program.last_iters(model))
    del model, solve
    loops.free(device)
    numbers = judge(cfg, win["sample"].items, designs, names, device)
    return dict(e2e=e2e, counters=counters, seg=seg, peak=peak,
                numbers=numbers, attempted=win["attempted"],
                failed=win["failed"])


def judge(cfg, sample, designs, names, device):
    """The sampled answers ([index, design, u]) of a window: each
    number's worst reading (``check.solve_numbers``)."""
    grid = check.ref_grid(cfg, device)
    fixed, f = ref.cantilever(grid)
    rows = []
    for _, d, u in sample:
        rho = designs[d].reshape(grid.shape).to(F64)
        rows.append(check.solve_numbers(grid, rho, check.as_grid(grid, u),
                                        fixed, f, "err" in names))
    return check.worst(rows)


def control(cfg, designs, keys, names, device, lowp=torch.bfloat16):
    """The control: the reference solve put in the program's place, its
    operator computed in ``lowp``, judged like the program's answers."""
    grid = check.ref_grid(cfg, device)
    low = check.ref_grid(cfg, device, lowp=lowp)
    fixed, f = ref.cantilever(grid)
    rows = []
    for d in keys:
        rho = designs[d].reshape(grid.shape).to(F64)
        u, _, _ = ref.solve(low, rho, fixed, f)
        rows.append(check.solve_numbers(grid, rho, u, fixed, f,
                                        "err" in names))
    return check.worst(rows)


def calibrate(cfg, mix, with_control, device, emit):
    """Every design of the set once through the timed call, each judged
    alone (a run's sample is drawn from these), then the control on the
    same designs; the forward error ``err`` is read beside the rest."""
    model, solve, designs = build(cfg, mix, device)
    for d, rho in enumerate(designs):
        nums = judge(cfg, [[0, d, solve(rho)]], designs, ["err"], device)
        emit(kind="program", design=d, iters=program.last_iters(model),
             **nums)
    del model, solve
    loops.free(device)
    for d in range(len(designs) if with_control else 0):
        emit(kind="control", design=d,
             **control(cfg, designs, [d], ["err"], device))
