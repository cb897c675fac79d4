"""The distributed graph engine (NWGraph+HPX adapted to PyTorch).

The public surface is the superstep-program API: algorithms are
``SuperstepProgram`` definitions (core/superstep.py) registered in
core/registry.py and built and cached through ``GraphEngine.program``.
See core/bfs.py, core/pagerank.py, core/sssp.py, core/cc.py,
core/kcore.py, core/betweenness.py, core/triangles.py, core/monotone.py
and core/incremental.py for the algorithm-level notes."""

from repro_torch.core import incremental, localops, registry
from repro_torch.core.api import CompiledProgram, GraphEngine
from repro_torch.core.graph import EllMeta, GraphShards, partition_graph
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import AsyncSuperstepProgram, \
    PhasedProgram, SuperstepProgram, run_phases, run_program, \
    run_program_async, run_program_batched

__all__ = [
    "AsyncSuperstepProgram", "CompiledProgram", "EllMeta", "GraphEngine",
    "GraphShards", "PhasedProgram", "StackedComm", "SuperstepProgram",
    "incremental", "localops", "partition_graph", "registry", "run_phases",
    "run_program", "run_program_async", "run_program_batched",
]
