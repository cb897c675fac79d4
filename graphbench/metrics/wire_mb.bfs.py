"""MB one part ships through the exchanges in a bfs call (StackedComm's tally around each traced call)."""

from graphbench import readers


def read(record):
    return readers.wire_mb_per_call(record, "bfs")
