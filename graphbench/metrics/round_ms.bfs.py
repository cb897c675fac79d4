"""Device ms a bfs call spends in the levels' own code, outside the local ops and exchanges: the frontier gather, where, pack_bits (the engine.round, bfs.push and bfs.pull spans' self time)."""

from graphbench import layers


def read(record):
    return layers.device_ms_per_call(record, "bfs", "engine.round", "bfs.push",
                                     "bfs.pull")
