"""Rounds a pagerank solve takes (engine.round spans a traced call)."""

from graphbench import layers


def read(record):
    return layers.count_per_call(record, "pagerank", "engine.round")
