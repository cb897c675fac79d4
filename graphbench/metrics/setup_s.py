"""Set-up seconds: from the start of the process to the first timed call
(generation, partition_graph, upload, kernel load, warm calls)."""


def read(record):
    return record.setup_s
