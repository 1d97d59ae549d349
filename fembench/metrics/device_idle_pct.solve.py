"""Share of the traced solves' wall time in which no device activity
ran (profiler)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "solve_ms"


def read(ctx):
    seg = ctx.seg
    if seg is None or not seg.device_activities:
        return None
    return seg.idle_pct
