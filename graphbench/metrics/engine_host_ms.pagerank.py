"""Host ms of a pagerank call in the engine's own code: the engine.call span less the loop's init, rounds and outputs inside it."""

from graphbench import layers


def read(record):
    return layers.host_self_ms_per_call(record, "pagerank", "engine.call")
