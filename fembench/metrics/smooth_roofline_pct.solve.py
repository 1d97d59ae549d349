"""The smoothing calls' and operator products' share of their roofline
in the traced solves: the least time the V-cycles and PCG products of
those solves need (``work.smoothing_work``) over the device time of the
kernels that ``kernels/smoothing.json`` assigns to the layer."""

LAYER = "smoothing and operator kernels (ops/fused_smooth.py: K2 in 2D; K5 and K4 in 3D)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "solve_ms"
TABLE = "smoothing"


def read(ctx):
    t = ctx.kernel_seconds(TABLE)
    if t is None:
        return None
    w = ctx.work
    vc = mv = 0
    for it in ctx.counters["trace_iters"]:
        a, b = w.solve_counts(ctx.cfg, it)
        vc, mv = vc + a, mv + b
    by, fl = getattr(w, ctx.table(TABLE)["work"])(ctx.cfg, vc, mv)
    return 100.0 * w.bound_s(by, fl) / t
