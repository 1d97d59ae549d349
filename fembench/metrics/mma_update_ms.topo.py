"""Device time per MMA iteration of the optimizer's ``mma_update`` stage: CUDA
events at its public stage hook (``DeviceTopo.mark``), in the traced
cycle."""

LAYER = "topo driver (opt/topo_device.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "mma_iter_ms"


def read(ctx):
    st = ctx.counters["stages"]
    return None if not st or "mma_update" not in st else st["mma_update"]
