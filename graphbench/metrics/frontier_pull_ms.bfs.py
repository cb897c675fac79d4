"""Device ms a bfs call spends in localops.frontier_pull (the bfs_pull kernel and its row order), from the traced window."""

from graphbench import layers


def read(record):
    return layers.device_ms_per_call(record, "bfs", "localops.frontier_pull")
