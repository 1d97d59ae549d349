from .mma import MMA, Problem
from .topo import TopoProblem, optimize_topology
from .topo_device import DeviceTopo
from .topo_sharded import ShardedDeviceTopo

__all__ = ["MMA", "Problem", "TopoProblem", "optimize_topology",
           "DeviceTopo", "ShardedDeviceTopo"]
