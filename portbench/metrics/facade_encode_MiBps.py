"""Uncompressed MiB/s of the window's encode calls of a single-stream
facade, their input bytes over their summed wall time: ``encode_MiBps``
under a bound of its own, since one chain on the device sets the facade's
encode and spreads far less than a container's host work."""

from portbench import readers


def read(run):
    return readers.rate(run, "encode")
