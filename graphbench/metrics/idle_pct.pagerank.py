"""Share of the traced pagerank window in which no device operation runs."""

from graphbench import readers


def read(record):
    return readers.idle_pct(record, "pagerank")
