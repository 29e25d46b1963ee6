"""Container host work of a decode, from the program's spans:
``parse_frame``, the payload matrix (``dec_host_prep``) and the error
reads (``dec_errors``), ms a profiled call."""

from portbench import spans


def read(run):
    return spans.span_ms(run, "decode", ("parse_frame", "dec_host_prep",
                                         "dec_errors"))
