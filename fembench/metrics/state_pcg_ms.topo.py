"""Device time per MMA iteration of the optimizer's ``state_pcg`` stage: CUDA
events at its public stage hook (``DeviceTopo.mark``), in the traced
cycle."""

LAYER = "topo driver (opt/topo_device.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "mma_iter_ms"


def read(ctx):
    st = ctx.counters["stages"]
    return None if not st or "state_pcg" not in st else st["state_pcg"]
