"""The filter's stencil products' share of their roofline in the traced
cycle: the least time of the products its PCG iterations need (one per
iteration forward and backward, and one mass product each way,
``work.filter_work``) over the device time of the kernels that
``kernels/stencil2d.json`` assigns to the layer.  The cycle's closing
filter application is not counted, so the share errs low."""

LAYER = "2D stencil product (ops/stencil_matvec.py: K9)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "mma_iter_ms"
TABLE = "stencil2d"


def read(ctx):
    t = ctx.kernel_seconds(TABLE)
    h = ctx.counters["trace_history"]
    if t is None or not h:
        return None
    products = sum(sum(r["filter_iters"]) + 2 for r in h)
    w = ctx.work
    by, fl = getattr(w, ctx.table(TABLE)["work"])(ctx.cfg, products)
    return 100.0 * w.bound_s(by, fl) / t
