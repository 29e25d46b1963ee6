"""Rows count recovery read (``recover.reads``) over the rows it was given
(``recover.blocks``), in the profiled calls: one read a row for each
candidate the row tries, so 1.0 is one EOI read a block.  Nothing to read
where a flavor has no count recovery (fixed 12-bit)."""

from portbench import spans


def read(run):
    return spans.ratio("recover.reads", "recover.blocks")
