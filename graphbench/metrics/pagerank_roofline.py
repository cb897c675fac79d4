"""Share of the HBM roofline: the pagerank call's least bytes, counted from the graph, at peak bandwidth over its device-busy time."""

from graphbench import readers


def read(record):
    return readers.roofline_pct(record, "pagerank")
