"""PCG iterations per solve in the window, from the model's public
counter ``last_solve_stats["iters"]``."""

LAYER = "GMG PCG (multigrid.pcg_gmg / pcg, behind models/base.py::_solve_gmg)"
UNIT = "iters"
SOURCE = "program_counter"
MOVES = "solve_ms"


def read(ctx):
    it = ctx.counters["iters"]
    return sum(it) / len(it) if it else None
