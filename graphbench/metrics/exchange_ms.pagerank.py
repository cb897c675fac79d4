"""Device ms a pagerank solve spends in the exchanges and collectives (every repro_torch.comm span), from the traced window."""

from graphbench import layers


def read(record):
    return layers.device_ms_per_call(record, "pagerank", "comm.*")
