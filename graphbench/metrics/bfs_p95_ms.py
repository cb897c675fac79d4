"""95th percentile of the time of every search in the window, from the
call to the synchronised parents."""

from graphbench import readers


def read(record):
    return readers.scaled(readers.percentile_s(record, "bfs", 95), 1e3)
