"""Container host work of a decode (``parallel.block``, ``parallel.framing``):
``dec_host_prep`` and the wall time outside every stage (``parse_frame``,
the joins), ms a staged call."""

from portbench import readers


def read(run):
    return readers.host_ms(run, "decode", "dec_host_prep")
