"""Filter PCG iterations per MMA iteration in the window, forward plus
backward (``DeviceTopo.history[k]["filter_iters"]``)."""

LAYER = "density filter (models/helmholtz.py)"
UNIT = "iters"
SOURCE = "program_counter"
MOVES = "mma_iter_ms"


def read(ctx):
    h = ctx.counters["history"]
    return sum(sum(r["filter_iters"]) for r in h) / len(h) if h else None
