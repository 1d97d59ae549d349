"""Share of the traced cycle's wall time in which no device activity
ran (profiler)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "mma_iter_ms"


def read(ctx):
    seg = ctx.seg
    if seg is None or not seg.device_activities:
        return None
    return seg.idle_pct
