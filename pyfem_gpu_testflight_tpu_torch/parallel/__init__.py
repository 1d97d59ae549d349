"""Multi-rank solvers over ``torch.distributed`` (port of the JAX
``parallel`` package): element sharding, sharded GMG and sharded AMG.

Each rank of a process group runs the same program on its block;
:func:`make_mesh` wraps an initialized group, and
:func:`launch.run_ranks` spawns the ranks of a run.
"""

from .sharding import (
    Mesh,
    ShardedElasticity,
    ShardedPoisson,
    make_mesh,
    pad_elements,
)
from .sharded_gmg import ShardedGMG2D, ShardedGMG3D
from .sharded_amg import ShardedAMGPCG, sharded_amg_pcg
from .launch import run_ranks
from .dryrun import dryrun_multichip

# The JAX package's exports, plus the port's own Mesh, run_ranks and
# dryrun_multichip.
__all__ = [
    "ShardedElasticity",
    "ShardedPoisson",
    "ShardedGMG2D",
    "ShardedGMG3D",
    "ShardedAMGPCG",
    "sharded_amg_pcg",
    "make_mesh",
    "pad_elements",
    "Mesh",
    "run_ranks",
    "dryrun_multichip",
]
