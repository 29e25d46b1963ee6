"""Uncompressed MiB/s of the window's encode calls: their input bytes over
their summed wall time."""

from portbench import readers


def read(run):
    return readers.rate(run, "encode")
