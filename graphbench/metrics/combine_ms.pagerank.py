"""Device ms a pagerank solve spends in localops.scatter_combine (spmv_ell over ell_dst and its row order), from the traced window."""

from graphbench import layers


def read(record):
    return layers.device_ms_per_call(record, "pagerank",
                                     "localops.scatter_combine")
