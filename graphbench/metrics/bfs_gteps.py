"""Graph500 traversed edges of every search completed in the window, over
the window's time, in billions a second."""

from graphbench import readers


def read(record):
    return readers.scaled(readers.rate_per_s(record, "bfs"), 1e-9)
