"""State-solve PCG iterations per MMA iteration in the window, from the
optimizer's public history (``DeviceTopo.history[k]["cg_iters"]``)."""

LAYER = "GMG PCG (multigrid.pcg_gmg / pcg, behind models/base.py::_solve_gmg)"
UNIT = "iters"
SOURCE = "program_counter"
MOVES = "mma_iter_ms"


def read(ctx):
    h = ctx.counters["history"]
    return sum(r["cg_iters"] for r in h) / len(h) if h else None
