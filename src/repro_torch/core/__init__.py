"""The distributed graph engine (NWGraph+HPX adapted to PyTorch).

The public surface is the superstep-program API: algorithms are
``SuperstepProgram`` definitions (core/superstep.py) registered in
core/registry.py and built and cached through ``GraphEngine.program``.
See core/bfs.py, core/pagerank.py, core/sssp.py, core/cc.py,
core/kcore.py, core/betweenness.py, core/triangles.py, core/monotone.py
and core/incremental.py for the algorithm-level notes, core/faults.py
and core/recovery.py for fault injection, guards and checkpointed
recovery."""

import torch.autograd.profiler
import torch.profiler

from repro_torch.core import incremental, localops, registry
from repro_torch.core.api import CompiledProgram, GraphEngine
from repro_torch.core.faults import FaultEvent, FaultSchedule
from repro_torch.core.graph import EllMeta, GraphShards, abstract_graph, \
    partition_graph
from repro_torch.core.partitioned import DistComm, StackedComm
from repro_torch.core.recovery import Checkpoint, CheckpointRunner, \
    RecoveryError, RunReport
from repro_torch.core.superstep import AsyncSuperstepProgram, \
    PhasedProgram, SuperstepProgram, run_phases, run_program, \
    run_program_async, run_program_batched
from repro_torch.obs import spans as _obs_spans

# the layer sites of core/ open the range repro_torch.<component>.<kind>
# while torch's profiler records (obs/spans.py; obs imports no torch).
# The range is torch's C++ one where torch has it: about 2 us a site on
# the host against record_function's 15, so a traced window's idle share
# stays near an untraced one's
_obs_spans.install_profiler(
    torch.autograd.profiler,
    getattr(torch._C._profiler, "_RecordFunctionFast",
            torch.profiler.record_function))

__all__ = [
    "AsyncSuperstepProgram", "Checkpoint", "CheckpointRunner",
    "CompiledProgram", "DistComm", "EllMeta", "FaultEvent", "FaultSchedule",
    "GraphEngine", "GraphShards", "PhasedProgram", "RecoveryError",
    "RunReport", "StackedComm", "SuperstepProgram", "incremental",
    "localops", "partition_graph", "registry", "run_phases", "run_program",
    "run_program_async", "run_program_batched",
]
