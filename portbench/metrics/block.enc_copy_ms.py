"""Host-device copies of an encode: ``enc_h2d`` + ``enc_d2h``, ms a staged
call."""

from portbench import readers


def read(run):
    return readers.stage_ms(run, "encode", ("enc_h2d", "enc_d2h"))
