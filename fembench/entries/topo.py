"""Entry ``topo``: the configuration's MMA loop (``DeviceTopo.optimize``)
in whole cycles of ``cycle`` iterations, each a fresh optimizer run from
the initial design, so the work of a cycle never depends on the
program's speed.  The last cycle's end is judged by the float64
reference, followed step by step from the program's own state.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from .. import check, loops, program
from ..reference import elasticity as ref
from ..reference import helmholtz, mma
from ..trace import Segment

F64 = torch.float64


class StageClock:
    """CUDA events at the optimizer's public stage hook (``DeviceTopo.mark``):
    the device time between consecutive marks, by the stage that ends."""

    def __init__(self):
        self.marks = []

    def start(self):
        self("(start)")

    def __call__(self, stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((stage, ev))

    def per_iteration_ms(self, iterations):
        torch.cuda.synchronize()
        tot = {}
        for (_, a), (stage, b) in zip(self.marks, self.marks[1:]):
            if stage != "(start)":
                tot[stage] = tot.get(stage, 0.0) + a.elapsed_time(b)
        return {k: v / iterations for k, v in tot.items()}


def build(cfg, mix, device):
    """(optimizer, timed call): the call runs one whole cycle and returns
    its history."""
    dt, _ = program.build_topo(cfg, device)
    cycle = int(mix["cycle"])

    def run_cycle():
        start = len(dt.history)
        dt.optimize(max_iterations=cycle, log_every=cycle, verbose=False)
        return dt.history[start:]

    return dt, run_cycle


def run(cfg, mix, seed, seconds, trace, device, t0, names):
    dt, run_cycle = build(cfg, mix, device)
    dt.optimize(max_iterations=mix["warmup"], log_every=mix["warmup"],
                verbose=False)
    loops.sync(device)
    setup_s = time.perf_counter() - t0
    loops.reset_peak(device)
    win = loops.topo_window(run_cycle, seconds, device)
    peak = loops.peak_bytes(device)
    done = sum(len(c) for c in win["cycles"])
    e2e = {
        "setup_s": (setup_s, "s"),
        "mma_iter_ms": (1e3 * win["elapsed"] / done if done
                        else float("nan"), "ms"),
        "peak_mem_gib": (peak / loops.GIB, "GiB"),
    }
    counters = {"history": [r for c in win["cycles"] for r in c],
                "trace_history": [], "stages": None}
    last = win["cycles"][-1] if win["cycles"] else []
    seg = None
    if trace:
        clock = StageClock() if torch.device(device).type == "cuda" else None
        dt.mark = clock
        with Segment(device) as seg:
            for _ in range(mix["trace_units"]):
                if clock is not None:
                    clock.start()
                with record_function("fembench.mma_cycle"):
                    last = run_cycle()
                counters["trace_history"] += last
        dt.mark = None
        if clock is not None:
            counters["stages"] = clock.per_iteration_ms(
                len(counters["trace_history"]))
    # the last cycle's end: every cycle starts from the same design and
    # repeats the same work, so the last answer stands for all
    state = tuple(dt.state)
    del dt, run_cycle
    loops.free(device)
    numbers = judge(cfg, state, last, names, device) if last else {}
    return dict(e2e=e2e, counters=counters, seg=seg, peak=peak,
                numbers=numbers, attempted=win["attempted"],
                failed=win["failed"])


def judge(cfg, state, history, names, device, lowp=None):
    """One optimizer cycle's end, followed from the program's own state.

    ``state`` is the cycle's final (x_10, x_9, x_8, low, upp, u_9) and
    ``history`` its per-iteration records.  The answer judged is the
    program's u_9, x_10 and recorded compliance and constraints; with
    ``lowp`` (the control) the reference's own iteration from x_9 with
    its element data (state operator, sensitivity, filter) computed in
    ``lowp`` takes their place.  The float64 reference refilters x_9 and
    recomputes, from the answer's own u_9, the sensitivity, its filtered
    gradient g and the MMA update x_ref from x_9 with the asymptotes the
    update used (the run keeps no earlier state, so the asymptote update
    itself is not recomputed).  Numbers, those in ``names``:

    * ``state_resid``: u_9's backward error, as ``resid`` of a solve;
    * ``obj``: |obj_9 - f.u_9| / |f.u_9| (the recorded compliance);
    * ``con``: |con_9 - (V - mean F x_9)| (the volume constraint);
    * ``con0``: the same at the start, x_0 = x_init;
    * ``design_gain``: |g.(x_10 - x_ref)| / |g.(x_ref - x_9)|, the error
      of the step's first-order change of the objective (a step that
      leaves the design unchanged reads exactly 1);
    * ``design_gw``: ||g (x_10 - x_ref)|| / ||g (x_ref - x_9)||, the
      step's error weighted by the sensitivity;
    * ``design``: ||x_10 - x_ref|| / ||x_ref - x_9||, the step's error.
    """
    t = cfg["topo"]
    V, lb = t["fixed_volume"], t["lb"]
    grid = check.ref_grid(cfg, device)
    fixed, f = ref.cantilever(grid)
    filt = helmholtz.Filter(cfg["grid"], cfg["lengths"], cfg["filter"]["r0"],
                            device)
    x9 = state[1].reshape(grid.shape).to(F64)
    low, upp = (a.reshape(grid.shape).to(F64) for a in state[3:5])
    ones = torch.full(grid.shape, 1.0 / x9.numel(), dtype=F64, device=device)

    def mma_step(g_of, flt, u, raw):
        rho = torch.clamp(raw, min=lb)
        dc = torch.where(raw > lb, -g_of.compliance_sens(rho, u), 0.0)
        g = flt.backward(dc)
        return mma.update(x9, low, upp, g, flt.backward(ones),
                          float(raw.mean()) - V, lb, t["ub"]), g

    raw = filt.forward(x9)
    rho = torch.clamp(raw, min=lb)
    if lowp is None:
        u = state[5].reshape((grid.nd,) + grid.shape).movedim(0, -1).to(F64)
        x10 = state[0].reshape(grid.shape).to(F64)
        obj, con, con0 = (history[-1]["obj"], history[-1]["con"][0],
                          history[0]["con"][0])
    else:
        lg = check.ref_grid(cfg, device, lowp)
        lf = helmholtz.Filter(cfg["grid"], cfg["lengths"],
                              cfg["filter"]["r0"], device, lowp)
        lraw = lf.forward(x9)
        u, _, _ = ref.solve(lg, torch.clamp(lraw, min=lb), fixed, f)
        x10, _ = mma_step(lg, lf, u, lraw)
        obj = float(torch.sum(f * u).to(lowp))
        con = V - float(lraw.mean())
        con0 = V - float(lf.forward(torch.full_like(x9, t["x_init"])).mean())
    r = torch.where(fixed, 0.0, f - grid.apply(rho, u))
    comp = float(torch.sum(f * u))
    x_ref, g = mma_step(grid, filt, u, raw)
    out = {
        "state_resid": float(torch.linalg.norm(r) / torch.linalg.norm(f)),
        "obj": abs(obj - comp) / abs(comp),
        "con": abs(con - (V - float(raw.mean()))),
        "con0": abs(con0 - (V - t["x_init"])),
    }
    steps = {
        "design_gain": lambda: float(torch.sum(g * (x10 - x_ref)).abs()
                                     / torch.sum(g * (x_ref - x9)).abs()),
        "design_gw": lambda: float(torch.linalg.norm(g * (x10 - x_ref))
                                   / torch.linalg.norm(g * (x_ref - x9))),
        "design": lambda: float(torch.linalg.norm(x10 - x_ref)
                                / torch.linalg.norm(x_ref - x9)),
    }
    out.update({k: fn() for k, fn in steps.items() if k in names})
    return out


def calibrate(cfg, mix, with_control, device, emit):
    """One cycle through the timed call (every cycle repeats it), judged
    with every step measure, then the control on the same state."""
    dt, run_cycle = build(cfg, mix, device)
    hist = run_cycle()
    state = tuple(dt.state)
    del dt, run_cycle
    loops.free(device)
    names = ["design_gain", "design_gw", "design"]
    emit(kind="program", cg_iters=[r["cg_iters"] for r in hist],
         filter_iters=[r["filter_iters"] for r in hist],
         **judge(cfg, state, hist, names, device))
    if with_control:
        emit(kind="control", **judge(cfg, state, hist, names, device,
                                     lowp=torch.bfloat16))
