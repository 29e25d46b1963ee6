"""The 95th percentile (nearest rank) of every encode call's latency in the
window, in ms."""

from portbench import readers


def read(run):
    return readers.p95_ms(run, "encode")
