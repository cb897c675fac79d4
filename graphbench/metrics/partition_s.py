"""Host seconds of the port's partition_graph in set-up."""


def read(record):
    return record.partition_s
