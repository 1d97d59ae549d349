"""Device activities (kernels, copies, sets) per PCG iteration in the
traced solves: the launch path's length per iteration."""

LAYER = "V-cycle and transfers (multigrid.GMG)"
UNIT = "ops/iter"
SOURCE = "device_trace"
MOVES = "solve_ms"


def read(ctx):
    it = sum(ctx.counters["trace_iters"])
    n = ctx.seg.device_activities
    return n / it if it and n else None
