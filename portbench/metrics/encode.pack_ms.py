"""The bit-pack of an encode (``ops.encode``): ``enc_pack``, ms a staged
call."""

from portbench import readers


def read(run):
    return readers.stage_ms(run, "encode", ("enc_pack",))
