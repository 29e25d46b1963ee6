"""Rows count recovery's candidate loop read (``recover.reads``) over the
rows it was given (``recover.blocks``), in the profiled calls: 1.0 would
be one EOI read a block; each candidate's read reads every row of the
batch.  Nothing to read where a flavor has no count recovery (fixed
12-bit)."""

from portbench import spans


def read(run):
    return spans.ratio("recover.reads", "recover.blocks")
