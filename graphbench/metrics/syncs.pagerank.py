"""Blocking host-device synchronisations inside a pagerank call, from the traced window's CUDA runtime events."""

from graphbench import readers


def read(record):
    return readers.syncs_per_call(record, "pagerank")
