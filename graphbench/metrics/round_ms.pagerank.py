"""Device ms a pagerank solve spends in the rounds' own code, outside the local ops and exchanges: the per-edge gather, the bf16 rounding, the rank update (the engine.round spans' self time)."""

from graphbench import layers


def read(record):
    return layers.device_ms_per_call(record, "pagerank", "engine.round")
