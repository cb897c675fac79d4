"""Push levels a bfs search takes (bfs.push spans a traced call)."""

from graphbench import layers


def read(record):
    return layers.count_per_call(record, "bfs", "bfs.push")
