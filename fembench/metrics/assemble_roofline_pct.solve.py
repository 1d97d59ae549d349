"""The level assembly's share of its roofline in the traced solves: the
least time of one hierarchy per solve (``work.assembly_work``) over the
device time of the kernels that ``kernels/assembly.json`` assigns to
the layer."""

LAYER = "level assembly (ops/fused_assemble.py: K1, K3)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "solve_ms"
TABLE = "assembly"


def read(ctx):
    t = ctx.kernel_seconds(TABLE)
    n = len(ctx.counters["trace_iters"])
    if t is None or not n:
        return None
    w = ctx.work
    by, fl = getattr(w, ctx.table(TABLE)["work"])(ctx.cfg, n)
    return 100.0 * w.bound_s(by, fl) / t
