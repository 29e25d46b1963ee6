"""The share of the profiled encode calls' wall time in which no kernel,
copy or fill ran on the card, in percent."""

from portbench import readers


def read(run):
    return readers.idle_pct(run, "encode")
