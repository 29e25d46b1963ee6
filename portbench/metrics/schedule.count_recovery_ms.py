"""Host count recovery of a variable-width decode (``kernels.schedule``):
``dec_count_recovery``, ms a staged call; nothing to read where a flavor
has none (fixed 12-bit)."""

from portbench import readers


def read(run):
    return readers.stage_ms(run, "decode", ("dec_count_recovery",))
