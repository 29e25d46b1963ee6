"""Host work of an encode, from the program's spans, ms a profiled call:
the container's block rows' build (``enc_host_prep``), payload slices
(``enc_payloads``), host decode of the verify sample (``enc_verify``) and
``pack_frame``; the facade's input staging (``enc_host_prep``,
``ops.encode``)."""

from portbench import spans


def read(run):
    return spans.span_ms(run, "encode", ("enc_host_prep", "enc_payloads",
                                         "enc_verify", "pack_frame"))
