"""Uncompressed MiB/s of the window's decode calls: their output bytes
over their summed wall time."""

from portbench import readers


def read(run):
    return readers.rate(run, "decode")
