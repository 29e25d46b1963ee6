"""Container host work of an encode, from the program's spans: the block
rows' build (``enc_host_prep``), the payload slices (``enc_payloads``),
the host decode of the verify sample (``enc_verify``) and ``pack_frame``,
ms a profiled call."""

from portbench import spans


def read(run):
    return spans.span_ms(run, "encode", ("enc_host_prep", "enc_payloads",
                                         "enc_verify", "pack_frame"))
