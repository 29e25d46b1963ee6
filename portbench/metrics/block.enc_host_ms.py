"""Container host work of an encode (``parallel.block``, ``parallel.framing``):
``enc_host_prep`` and the wall time outside every stage (payload slices,
``pack_frame``, ``_verify_sample``), ms a staged call."""

from portbench import readers


def read(run):
    return readers.host_ms(run, "encode", "enc_host_prep")
