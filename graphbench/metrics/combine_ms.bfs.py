"""Device ms a bfs call spends in the OR-combine: what localops.scatter_combine launches itself (its repro_torch.localops span), from the traced window."""

from graphbench import layers


def read(record):
    return layers.device_ms_per_call(record, "bfs", "localops.scatter_combine")
