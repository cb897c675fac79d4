"""The distributed graph engine (NWGraph+HPX adapted to PyTorch).

The public surface is the superstep-program API: algorithms are
``SuperstepProgram`` definitions (core/superstep.py) registered in
core/registry.py and built and cached through ``GraphEngine.program``.
See core/bfs.py and core/pagerank.py for the algorithm-level notes."""

from repro_torch.core import localops, registry
from repro_torch.core.api import CompiledProgram, GraphEngine
from repro_torch.core.graph import EllMeta, GraphShards, partition_graph
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import SuperstepProgram, run_program

__all__ = [
    "CompiledProgram", "EllMeta", "GraphEngine", "GraphShards",
    "StackedComm", "SuperstepProgram", "localops", "partition_graph",
    "registry", "run_program",
]
