"""Device time per MMA iteration of the filter's forward and backward
stages (``filter_fwd`` + ``filter_bwd`` at ``DeviceTopo.mark``), in the
traced cycle."""

LAYER = "density filter (models/helmholtz.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "mma_iter_ms"


def read(ctx):
    st = ctx.counters["stages"]
    if not st or "filter_fwd" not in st or "filter_bwd" not in st:
        return None
    return st["filter_fwd"] + st["filter_bwd"]
