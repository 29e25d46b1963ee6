"""The bit-pack of an encode (``ops.encode.pack_dense``, which the
container's encode and the facade's share), from the program's span
``enc_pack``, ms a profiled call.  The profiler's event on each torch op
of the pack counts in it: it reads several times the pack's unprofiled
time, so compare it with itself."""

from portbench import spans


def read(run):
    return spans.span_ms(run, "encode", ("enc_pack",))
