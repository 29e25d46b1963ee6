"""Host-device copies of a decode: ``dec_h2d`` + ``dec_d2h_out``, ms a staged
call."""

from portbench import readers


def read(run):
    return readers.stage_ms(run, "decode", ("dec_h2d", "dec_d2h_out"))
