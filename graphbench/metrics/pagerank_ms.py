"""The window's time over the PageRank solves completed in it."""

from graphbench import readers


def read(record):
    return readers.scaled(readers.time_per_call_s(record, "pagerank"), 1e3)
