"""Seconds from the start of the process to the first timed call."""


def read(run):
    return run.setup_s
