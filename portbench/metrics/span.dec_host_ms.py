"""Host work of a decode, from the program's spans, ms a profiled call:
the container's ``parse_frame``, payload matrix (``dec_host_prep``) and
error reads (``dec_errors``); the facade's stream staging
(``dec_host_prep``) and error read (``dec_errors``, ``api``)."""

from portbench import spans


def read(run):
    return spans.span_ms(run, "decode", ("parse_frame", "dec_host_prep",
                                         "dec_errors"))
